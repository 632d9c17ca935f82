"""The port's ``test_utils.py`` and ``rss_profiler.py`` against the JAX
package's: ``rand_tensor`` draws what ``rand_array`` draws for every
dtype numpy holds (and a tensor of every other stored dtype),
``assert_state_dict_eq`` agrees with the JAX helper on the same pairs,
and ``measure_rss_deltas`` sees an allocation and sets the
``rss_peak_delta_bytes`` gauge."""

import numpy as np
import pytest
import torch

from torchsnapshot_tpu import test_utils as jtu
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import test_utils as ttu
from torchsnapshot_tpu_torch.rss_profiler import measure_rss_deltas
from torchsnapshot_tpu_torch.serialization import _NUMPY_DTYPES, _TORCH_DTYPES


@pytest.mark.parametrize("name", sorted(_TORCH_DTYPES))
def test_rand_tensor_draws_what_rand_array_draws(name):
    t = ttu.rand_tensor((3, 5), _TORCH_DTYPES[name], seed=4)
    assert t.dtype == _TORCH_DTYPES[name] and tuple(t.shape) == (3, 5)
    if name in _NUMPY_DTYPES:
        want = jtu.rand_array((3, 5), np.dtype(name), seed=4)
        assert t.numpy().tobytes() == want.tobytes()


def _pair(w_scale, w_shift):
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    a = {"w": w, "n": [1, 2.5, "x"], "s": {"k": 3}}
    b = {"w": w * np.float32(w_scale) + np.float32(w_shift), "n": [1, 2.5, "x"], "s": {"k": 3}}
    return a, b


@pytest.mark.parametrize("scale,shift,equal", [(1 + 1e-7, 0, True), (1, 1, False), (1 + 1e-3, 0, False)])
def test_assert_state_dict_eq_agrees_with_jax(scale, shift, equal):
    a, b = _pair(scale, shift)
    ta, tb = ({**d, "w": torch.from_numpy(d["w"])} for d in (a, b))
    for helper, x, y in ((jtu.assert_state_dict_eq, a, b), (ttu.assert_state_dict_eq, ta, tb)):
        if equal:
            helper(x, y)
        else:
            with pytest.raises(AssertionError):
                helper(x, y)
    with pytest.raises(AssertionError, match="dtype"):
        ttu.assert_state_dict_eq(torch.zeros(2), torch.zeros(2, dtype=torch.float64))


def test_measure_rss_deltas_sees_an_allocation():
    deltas = []
    with measure_rss_deltas(deltas, interval_s=0.01):
        block = np.ones(64 << 20, dtype=np.uint8)  # 64 MiB, touched
        block[::4096] = 2
    assert max(deltas) >= 32 << 20
    assert tts.obs.metrics_snapshot()["gauges"][tts.obs.RSS_PEAK_DELTA_BYTES]["value"] == max(deltas)
