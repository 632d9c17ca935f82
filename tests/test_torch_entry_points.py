"""Storage plugins of the port: the built-in ``memory://`` scheme and a
third-party plugin discovered under the port's own entry-point group,
``torchsnapshot_tpu_torch.storage_plugins`` (after
``tests/test_entry_points.py``, which covers the JAX package's group).

A real distribution layout (a module and a ``dist-info`` with
``entry_points.txt``) is put on ``sys.path`` of a fresh interpreter, so
discovery runs as it would for an installed package.  A plugin
registered only under the JAX package's group is not loaded by the
port; a matched plugin's own errors propagate.
"""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch.storage import url_to_storage_plugin
from torchsnapshot_tpu_torch.storage.memory import MemoryStoragePlugin, reset_namespace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fake_dist(root, name, entry_points_txt, module_src):
    os.makedirs(os.path.join(root, f"{name}-0.1.dist-info"))
    with open(os.path.join(root, f"{name}-0.1.dist-info", "METADATA"), "w") as f:
        f.write(f"Metadata-Version: 2.1\nName: {name}\nVersion: 0.1\n")
    with open(os.path.join(root, f"{name}-0.1.dist-info", "entry_points.txt"), "w") as f:
        f.write(entry_points_txt)
    with open(os.path.join(root, f"{name}.py"), "w") as f:
        f.write(module_src)


_PLUGIN_SRC = """
from torchsnapshot_tpu_torch.storage.memory import MemoryStoragePlugin

def make_plugin(path, **opts):
    if opts:
        raise TypeError(f"unexpected storage option(s) {sorted(opts)}")
    return MemoryStoragePlugin(namespace="ep_" + path)
"""


def test_memory_scheme_takes_and_restores():
    state = {"w": torch.arange(1000, dtype=torch.float32), "n": torch.tensor([7])}
    try:
        assert isinstance(url_to_storage_plugin("memory://ep_mem"), MemoryStoragePlugin)
        tts.Snapshot.take("memory://ep_mem/s", {"app": tts.StateDict(dict(state))})
        dest = tts.StateDict(w=torch.zeros(1000), n=torch.zeros(1, dtype=torch.int64))
        tts.Snapshot("memory://ep_mem/s").restore({"app": dest}, device="cpu")
        assert torch.equal(dest["w"], state["w"]) and torch.equal(dest["n"], state["n"])
        assert tts.verify_snapshot("memory://ep_mem/s", deep=True).ok
    finally:
        reset_namespace("ep_mem/s")
    with pytest.raises(RuntimeError, match="no storage plugin registered for scheme 'nope'"):
        url_to_storage_plugin("nope://x")


def test_storage_plugin_discovered_under_the_ports_group(tmp_path):
    _fake_dist(str(tmp_path), "fake_tsnp_torch_plugin",
               "[torchsnapshot_tpu_torch.storage_plugins]\n"
               "myscheme = fake_tsnp_torch_plugin:make_plugin\n", _PLUGIN_SRC)
    _fake_dist(str(tmp_path), "fake_tsnp_jax_only",
               "[torchsnapshot_tpu.storage_plugins]\n"
               "jaxonly = fake_tsnp_torch_plugin:make_plugin\n", "")
    code = textwrap.dedent("""
        import sys
        sys.path.insert(0, sys.argv[1])
        sys.path.insert(0, sys.argv[2])
        import torch
        import torchsnapshot_tpu_torch as tts
        from torchsnapshot_tpu_torch.storage import url_to_storage_plugin

        plugin = url_to_storage_plugin("myscheme://bucket1")
        assert type(plugin).__name__ == "MemoryStoragePlugin" and plugin.namespace == "ep_bucket1"
        tts.Snapshot.take("myscheme://bucket2/s", {"m": tts.StateDict(x=torch.arange(8.0), n=3)})
        dest = tts.StateDict(x=torch.zeros(8), n=0)
        tts.Snapshot("myscheme://bucket2/s").restore({"m": dest}, device="cpu")
        assert torch.equal(dest["x"], torch.arange(8.0)) and dest["n"] == 3
        try:
            url_to_storage_plugin("jaxonly://x")
            raise AssertionError("the JAX package's group was loaded")
        except RuntimeError as e:
            assert "no storage plugin registered" in str(e)
        try:
            url_to_storage_plugin("myscheme://y", {"bogus": 1})
            raise AssertionError("a plugin's own error was swallowed")
        except TypeError as e:
            assert "bogus" in str(e)
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path), REPO], capture_output=True, text=True,
        env=env, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("OK")
