"""The PyTorch port stands alone: importing it loads neither ``jax`` nor
anything of ``torchsnapshot_tpu``, and no module of it imports either
(an AST scan, so imports inside functions count too)."""

import ast
import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_REPO, "torchsnapshot_tpu_torch")
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "msgpack", "psutil",
              "torchsnapshot_tpu")


def _port_modules():
    for dirpath, _, files in os.walk(_PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(dirpath, f), _REPO)


def _imported_roots(path):
    tree = ast.parse(open(os.path.join(_REPO, path)).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_port_modules()))
def test_module_imports_nothing_forbidden(path):
    bad = sorted(set(_imported_roots(path)) & set(_FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_chip_smoke_imports_nothing_forbidden():
    bad = sorted(set(_imported_roots("chip_smoke.py")) & set(_FORBIDDEN))
    assert not bad, f"chip_smoke.py imports {bad}"


def test_import_leaves_jax_unloaded():
    code = (
        "import sys\n"
        "import torchsnapshot_tpu_torch\n"
        "import torchsnapshot_tpu_torch.ops.device_pack\n"
        "import torchsnapshot_tpu_torch.ops.flash_attention\n"
        "import torchsnapshot_tpu_torch.parallel.ring_attention\n"
        "import torchsnapshot_tpu_torch.models.transformer\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {_FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=_REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
