"""Test helpers: tensor-aware state-dict equality, random tensors of
every supported dtype, and a multi-process launcher with a deadline.

Counterpart of ``torchsnapshot_tpu/test_utils.py``.  The launcher runs
plain subprocesses that coordinate through a ``FileCoordinator`` over a
shared directory; it kills every worker once the deadline passes.
"""

from __future__ import annotations

import math
import os
import subprocess
import sys
import textwrap
import time
from typing import Any, List, Optional

import numpy as np
import torch

from .serialization import _NUMPY_DTYPES, _TORCH_DTYPES


def _as_tensor(x: Any) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_state_dict_eq(a: Any, b: Any, path: str = "") -> None:
    """Structural equality with tensor-aware leaves: tensors and numpy
    arrays must agree in shape and dtype, floating and complex values
    within a relative 1e-6 (NaN equal to NaN), all others exactly."""
    arr_a = isinstance(a, (torch.Tensor, np.ndarray))
    arr_b = isinstance(b, (torch.Tensor, np.ndarray))
    if arr_a or arr_b:
        ta, tb = _as_tensor(a), _as_tensor(b)
        assert ta.shape == tb.shape, f"{path}: shape {tuple(ta.shape)} != {tuple(tb.shape)}"
        assert ta.dtype == tb.dtype, f"{path}: dtype {ta.dtype} != {tb.dtype}"
        if ta.is_floating_point() or ta.is_complex():
            wide = torch.complex128 if ta.is_complex() else torch.float64
            # float8 converts only through float32
            ta, tb = (t.to(torch.float32) if t.element_size() == 1 else t for t in (ta, tb))
            torch.testing.assert_close(
                ta.to(wide), tb.to(wide), rtol=1e-6, atol=0, equal_nan=True, msg=path
            )
        else:
            assert torch.equal(ta, tb), f"{path}: values differ"
        return
    if isinstance(a, dict) and isinstance(b, dict):
        assert a.keys() == b.keys(), f"{path}: keys {a.keys()} != {b.keys()}"
        for k in a:
            assert_state_dict_eq(a[k], b[k], f"{path}/{k}")
        return
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        assert len(a) == len(b), f"{path}: len {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            assert_state_dict_eq(x, y, f"{path}/{i}")
        return
    if isinstance(a, float) and isinstance(b, float):
        assert math.isclose(a, b, rel_tol=1e-9) or (
            math.isnan(a) and math.isnan(b)
        ), f"{path}: {a} != {b}"
        return
    assert a == b, f"{path}: {a!r} != {b!r}"


def rand_tensor(shape, dtype: torch.dtype, seed: int = 0, device: Any = "cpu") -> torch.Tensor:
    """A random tensor of any dtype the format stores, drawn from a numpy
    generator seeded with ``seed`` as the JAX package's ``rand_array``
    draws it: standard normal values for floating and complex types (a
    dtype numpy lacks, bfloat16 or float8, through float32), 0/1 for
    bool, integers in [-1000, 1000] clipped to the type's range."""
    if dtype not in _TORCH_DTYPES.values():
        raise ValueError(f"unsupported dtype {dtype}")
    rng = np.random.default_rng(seed)
    name = str(dtype).removeprefix("torch.")
    if dtype.is_floating_point or dtype.is_complex:
        draw = rng.standard_normal(shape)
        if name in _NUMPY_DTYPES:
            t = torch.from_numpy(draw.astype(name))
        else:
            t = torch.from_numpy(draw.astype(np.float32)).to(dtype)
    elif dtype == torch.bool:
        t = torch.from_numpy(rng.integers(0, 2, size=shape).astype(bool))
    else:
        info = torch.iinfo(dtype)
        lo, hi = max(info.min, -1000), min(info.max, 1000)
        t = torch.from_numpy(rng.integers(lo, hi + 1, size=shape).astype(name))
    return t.to(device)


def run_multiprocess(
    tmp_path,
    world_size: int,
    body: str,
    repo_root: Optional[str] = None,
    timeout_s: float = 120.0,
) -> List[str]:
    """Run ``body`` (python source; bound names: ``rank``, ``world``,
    ``coord`` a ``FileCoordinator``, ``snap_dir``, ``np``, ``torch``,
    ``tts``) in ``world_size`` subprocesses and return their outputs.
    Raises when a worker fails, and kills every worker still running
    ``timeout_s`` seconds after the start."""
    repo = repo_root or os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(str(tmp_path), "mp_worker.py")
    with open(script, "w") as f:
        f.write(
            textwrap.dedent(
                f"""
                import sys
                sys.path.insert(0, {repo!r})
                import numpy as np
                import torch
                import torchsnapshot_tpu_torch as tts

                rank = int(sys.argv[1])
                world = int(sys.argv[2])
                coord = tts.FileCoordinator({os.path.join(str(tmp_path), "kv")!r}, rank, world)
                snap_dir = {os.path.join(str(tmp_path), "snap")!r}
                """
            )
            + textwrap.dedent(body)
        )
    procs = [
        subprocess.Popen(
            [sys.executable, script, str(r), str(world_size)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for r in range(world_size)
    ]
    deadline = time.monotonic() + timeout_s
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(0.0, deadline - time.monotonic()))[0].decode())
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate(timeout=10)
        raise AssertionError(f"workers did not finish within {timeout_s} s") from None
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"worker {r} failed:\n{out}")
    return outs
