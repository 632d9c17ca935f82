"""Nothing under portbench/ imports JAX or the JAX package, and the
reference imports nothing of the program.  Top-level module names are
compared whole: the port's name begins with the JAX package's."""

import ast
import os
import subprocess
import sys

import pytest

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "torchsnapshot_tpu"}
SOURCES = sorted(
    os.path.join(d, f) for d, _, fs in os.walk(harness.HERE) for f in fs if f.endswith(".py")
)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, harness.HERE))
def test_no_jax_and_no_program_in_the_reference(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN
    if os.sep + "reference" + os.sep in path:
        assert "torchsnapshot_tpu_torch" not in tops and "portbench" not in tops


def test_harness_refuses_loaded_jax_modules():
    assert harness.FORBIDDEN == FORBIDDEN
    code = (
        "import sys; sys.path[:0] = [sys.argv[1]]; import types; "
        "sys.modules['torchsnapshot_tpu'] = types.ModuleType('torchsnapshot_tpu'); "
        "from portbench import harness; import torchsnapshot_tpu_torch; "
        "print(harness.loaded_forbidden())"
    )
    out = subprocess.run([sys.executable, "-c", code, harness.ROOT], capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "['torchsnapshot_tpu']"


def test_a_run_loads_no_jax():
    code = (
        "import sys, time; sys.path[:0] = [sys.argv[1]]; "
        "from portbench.tests.tiny import run_tiny; run_tiny('deepseek_llm_7b.take', 0.2); "
        "from portbench import harness; print(harness.loaded_forbidden())"
    )
    out = subprocess.run([sys.executable, "-c", code, harness.ROOT], capture_output=True, text=True, timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stderr[-2000:]
