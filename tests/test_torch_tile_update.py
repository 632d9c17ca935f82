"""K6's plain version (``tile_update_plain``) and its wrapper on CPU
tensors against the JAX package's tile update executable
(``_compiled_tile_update``) on the JAX CPU backend, bitwise, at odd
offsets and ragged last tiles; and the tile plan against the JAX
package's.  Inputs come from a seeded numpy generator."""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from torchsnapshot_tpu.ops import device_pack as jdp
from torchsnapshot_tpu_torch.ops import device_pack as tdp
from torchsnapshot_tpu_torch.serialization import tensor_from_buffer


def _np(rng, dtype, n):
    if dtype == "bf16":
        return rng.standard_normal(n).astype(ml_dtypes.bfloat16)
    if np.dtype(dtype).kind == "f":
        return rng.standard_normal(n).astype(dtype)
    return rng.integers(-1000, 1000, n).astype(dtype)


def _t(a):
    name = "bfloat16" if a.dtype == ml_dtypes.bfloat16 else str(a.dtype)
    return tensor_from_buffer(bytearray(a.tobytes()), name, a.shape)


def _bytes(t):
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def test_plan_flat_tiles_matches_jax():
    from torchsnapshot_tpu.preparers.array import _plan_flat_tiles as jplan

    from torchsnapshot_tpu_torch.preparers.array import _plan_flat_tiles as tplan

    for args in [(0, 1000, 4, 256, 0), (17, 1023, 2, 100, 64), (5, 6, 8, 4, 8), (0, 4096, 1, 4096, 0)]:
        assert tplan(*args) == jplan(*args), args


# 32-bit and narrower: the JAX CPU backend runs without x64 here
_TILE_PAIRS = [
    ("bf16", np.float32), (np.float16, np.float32), (np.float32, "bf16"),
    (np.float32, np.float16), (np.int16, np.int32), (np.int8, np.int32),
    (np.float32, np.float32), (np.uint8, np.uint8), ("bf16", "bf16"),
]


@pytest.mark.parametrize("src_dt,dst_dt", _TILE_PAIRS, ids=lambda d: getattr(d, "__name__", str(d)))
def test_tile_update_plain_matches_jax_compiled_tile_update(src_dt, dst_dt):
    """At an odd offset, a 2-element tile at the end, a last tile and a
    tile covering the whole accumulator."""
    rng = np.random.default_rng(7)
    dev = jax.devices("cpu")[0]
    for n, off, tile in [(1001, 7, 333), (1001, 999, 2), (4096, 3000, 1096), (10, 0, 10)]:
        acc = _np(rng, dst_dt, n)
        t = _np(rng, src_dt, tile)
        fn = jdp._compiled_tile_update(n, str(acc.dtype), tile, str(t.dtype), dev)
        want = np.asarray(fn(jax.device_put(acc, dev), jax.device_put(t, dev), np.int32(off)))
        got = tdp.tile_update_plain(_t(acc), off, _t(t))
        assert _bytes(got) == want.tobytes(), (n, off, tile)
        before = dict(tdp.LAUNCHES)
        got2 = tdp.tile_update(_t(acc), off, _t(t))
        assert _bytes(got2) == want.tobytes(), (n, off, tile)
        assert tdp.LAUNCHES == before  # CPU tensors take the plain version
