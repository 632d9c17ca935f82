"""``python -m torchsnapshot_tpu_torch`` against ``python -m
torchsnapshot_tpu``: ``ls``, ``manifest``, ``verify``, ``steps`` and
``delete`` print the same lines and exit with the same codes on the same
snapshot and root, written by either package.  The commands the port
lacks exit 1 naming their ROADMAP item.  One run through a subprocess
checks the module entry point itself.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu.__main__ import main as jax_main
from torchsnapshot_tpu_torch.__main__ import main as port_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state(pkg, step):
    rng = np.random.default_rng(step)
    arrays = {
        "w": rng.standard_normal((16, 4)).astype(np.float32),
        "ids": rng.integers(-1000, 1000, (5000,)).astype(np.int64),
        "e": np.zeros((0, 3), np.float32),
    }
    if pkg == "port":
        return {"app": tts.StateDict(step=step, name="run", **{k: torch.from_numpy(v) for k, v in arrays.items()})}
    return {"app": jts.StateDict(step=step, name="run", **arrays)}


def _run(main, argv, capsys):
    rc = main(list(argv))
    out = capsys.readouterr()
    return rc, out.out, out.err


def _both(argv, capsys):
    port = _run(port_main, argv, capsys)
    jax = _run(jax_main, argv, capsys)
    assert port == jax, (argv, port, jax)
    return port


@pytest.mark.parametrize("taker", ["port", "jax"])
def test_ls_manifest_and_verify_print_what_jax_prints(tmp_path, taker, capsys):
    path = str(tmp_path / "s")
    (tts if taker == "port" else jts).Snapshot.take(path, _state(taker, 1))
    rc, out, _ = _both(["ls", path], capsys)
    assert rc == 0 and out.endswith("5 entries\n") and "0/app/ids" in out
    rc, out, _ = _both(["manifest", path], capsys)
    assert rc == 0 and '"world_size": 1' in out
    for argv in (["verify", path], ["verify", path, "--deep"], ["verify", path, "--rank", "0"]):
        rc, out, _ = _both(argv, capsys)
        assert rc == 0 and out.startswith("OK (")
    # one flipped byte: the deep audit fails, in both CLIs alike
    loc = jts.Snapshot(path).metadata.manifest["0/app/w"].location
    with open(os.path.join(path, loc), "r+b") as f:
        f.seek(3)
        b = f.read(1)
        f.seek(3)
        f.write(bytes([b[0] ^ 0x01]))
    rc, out, _ = _both(["verify", path, "--deep"], capsys)
    assert rc == 1 and out.startswith("FAILED corrupt=")
    rc, out, _ = _both(["verify", path], capsys)
    assert rc == 0
    os.remove(os.path.join(path, loc))
    rc, out, _ = _both(["verify", path], capsys)
    assert rc == 1 and out.startswith("FAILED missing=")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_steps_and_delete_print_what_jax_prints(tmp_path, writer, capsys):
    root = str(tmp_path / "run")
    rc, out, err = _both(["steps", root], capsys)
    assert rc == 0 and out == "" and err == "(no committed snapshots)\n"
    mgr = (tts if writer == "port" else jts).SnapshotManager(root)
    for step in (2, 5):
        mgr.save(_state(writer, step), step=step)
    rc, out, _ = _both(["steps", root], capsys)
    assert out == f"2\t{root}/step_0000000002\n5\t{root}/step_0000000005\n"
    rc, out, err = _both(["delete", mgr.path_for_step(2)], capsys)
    assert rc == 2 and err == "refusing to delete without --yes\n"
    assert os.path.exists(mgr.path_for_step(2))
    rc, out, _ = _run(port_main, ["delete", mgr.path_for_step(2), "--yes"], capsys)
    assert rc == 0 and out == f"deleted {mgr.path_for_step(2)}\n"
    assert not os.path.exists(mgr.path_for_step(2))
    assert _run(jax_main, ["steps", root], capsys)[1] == f"5\t{root}/step_0000000005\n"
    # a path that holds no snapshot: the same one-line error and code
    rc, out, err = _both(["verify", mgr.path_for_step(2)], capsys)
    assert rc == 1 and err.startswith("error: no .snapshot_metadata")
    rc, out, err = _both(["ls", mgr.path_for_step(2)], capsys)
    assert rc == 1


def test_unported_commands_name_their_roadmap_item(tmp_path, capsys):
    for cmd, item in (("stats", "2"), ("doctor", "2"), ("trace", "2"), ("tiers", "3.5"),
                      ("cas", "3.3"), ("convert", "4"), ("lint", "8")):
        rc, out, err = _run(port_main, [cmd, str(tmp_path), "--json"], capsys)
        assert rc == 1 and out == "" and f"queue A item {item}" in err, (cmd, err)


def test_module_entry_point_runs(tmp_path):
    path = str(tmp_path / "s")
    tts.Snapshot.take(path, _state("port", 3))
    proc = subprocess.run(
        [sys.executable, "-m", "torchsnapshot_tpu_torch", "verify", path, "--deep"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0 and proc.stdout.startswith("OK ("), proc.stdout + proc.stderr
