"""The plain version of the flash-attention forward kernel (K3) and the
port's ring attention against the JAX package's Pallas kernel, run in
interpret mode on the CPU as tests/test_flash_attention.py runs it.
f32 inputs from a seeded numpy generator; tolerance atol = rtol = 2e-5
(the same products summed in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchsnapshot_tpu.ops.flash_attention import (
    PALLAS_AVAILABLE,
    flash_attention as jax_flash_attention,
    flash_attention_partials as jax_partials,
)
from torchsnapshot_tpu.parallel.ring_attention import (
    dense_attention as jax_dense_attention,
)
from torchsnapshot_tpu_torch.ops import flash_attention as tfa
from torchsnapshot_tpu_torch.parallel.ring_attention import (
    dense_attention,
    ring_attention,
)

TOL = dict(rtol=2e-5, atol=2e-5)

needs_pallas = pytest.mark.skipif(not PALLAS_AVAILABLE, reason="pallas unavailable")


def _qkv(b, s, h, d, seed, sk=None):
    rng = np.random.default_rng(seed)
    mk = lambda sl: rng.standard_normal((b, sl, h, d)).astype(np.float32)  # noqa: E731
    return mk(s), mk(sk or s), mk(sk or s)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, name=""):
    np.testing.assert_allclose(
        got.detach().float().numpy(), np.asarray(want, np.float32), err_msg=name, **TOL
    )


@needs_pallas
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize(
    "shape,offsets",
    [((1, 128, 2, 64), (0, 0)), ((2, 96, 2, 48), (0, 0)),
     ((1, 64, 1, 32), (256, 128)), ((1, 200, 2, 16), (64, 0))],
    ids=["aligned", "ragged", "offset", "offset-ragged"],
)
def test_partials_match_pallas(causal, shape, offsets):
    b, s, h, d = shape
    q, k, v = _qkv(b, s, h, d, seed=s + d, sk=s + 40)
    qo, ko = offsets
    scale = 1.0 / np.sqrt(d)
    want = jax_partials(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), qo, ko, causal, scale)
    got = tfa.flash_attention_partials(*_t(q, k, v), qo, ko, causal, scale)
    for g, w, name in zip(got, want, ("pv", "m", "l", "valid")):
        _close(g, w, name)


@needs_pallas
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 128, 2, 64), (2, 100, 3, 32)], ids=["aligned", "odd"])
def test_normalised_matches_pallas_and_dense(causal, shape):
    q, k, v = _qkv(*shape, seed=11)
    got = tfa.flash_attention(*_t(q, k, v), causal=causal)
    _close(got, jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    _close(got, jax_dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))


@needs_pallas
def test_fully_masked_rows_are_invalid():
    # q rows entirely before the k block in the global sequence
    q, k, v = _qkv(1, 64, 1, 32, seed=5)
    got = tfa.flash_attention_partials(*_t(q, k, v), 0, 4096, True, 0.125)
    want = jax_partials(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0, 4096, True, 0.125)
    assert not bool(got[3].any()) and not bool(np.asarray(want[3]).any())
    assert torch.equal(got[2], torch.zeros_like(got[2]))
    for g, w in zip(got, want):
        _close(g, w)


@needs_pallas
@pytest.mark.parametrize("sq_real,sk_real", [(50, 70), (64, 33), (1, 96)])
def test_real_length_masks_match_truncated_inputs(sq_real, sk_real):
    """Rows ≥ sq_real and columns ≥ sk_real are masked in the kernel: the
    partials equal the JAX kernel's on inputs cut to those lengths, and
    the masked rows are empty (m = -inf, l = 0, pv = 0)."""
    b, s, h, d = 1, 64, 2, 16
    q, k, v = _qkv(b, s, h, d, seed=sq_real, sk=96)
    to_bh = lambda a: torch.from_numpy(a).permute(0, 2, 1, 3).reshape(b * h, a.shape[1], d)  # noqa: E731
    pv, m, l = tfa.attend_partials(
        to_bh(q), to_bh(k), to_bh(v), 8, 0, True, 0.25, sq_real=sq_real, sk_real=sk_real
    )
    wpv, wm, wl, _ = jax_partials(
        jnp.asarray(q[:, :sq_real]), jnp.asarray(k[:, :sk_real]),
        jnp.asarray(v[:, :sk_real]), 8, 0, True, 0.25,
    )
    wpv = np.asarray(wpv).transpose(0, 2, 1, 3).reshape(b * h, sq_real, d)
    _close(pv[:, :sq_real], wpv, "pv")
    _close(torch.where(torch.isfinite(m), m, 0.0)[:, :sq_real],
           np.asarray(wm).reshape(b * h, sq_real), "m")
    _close(l[:, :sq_real], np.asarray(wl).reshape(b * h, sq_real), "l")
    assert torch.isneginf(m[:, sq_real:]).all()
    assert (l[:, sq_real:] == 0).all() and (pv[:, sq_real:] == 0).all()


def test_plain_partials_match_block_form():
    """The plain version is _block_attend's math: checked against the
    port's dense oracle after normalisation, no JAX involved."""
    q, k, v = _qkv(2, 48, 2, 8, seed=2)
    scale = 1.0 / np.sqrt(8)
    pv, m, l, valid = tfa.flash_attention_partials(*_t(q, k, v), 0, 0, True, scale)
    out = pv / l.permute(0, 2, 1)[..., None]
    torch.testing.assert_close(out, dense_attention(*_t(q, k, v)), **TOL)
    assert bool(valid.all())


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_size_one_matches_dense(causal):
    q, k, v = _qkv(2, 72, 3, 16, seed=4)
    got = ring_attention(*_t(q, k, v), causal=causal)
    want = jax_dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    _close(got, want)
    _close(dense_attention(*_t(q, k, v), causal=causal), want)


def test_attend_partials_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError):
        tfa.attend_partials(q, q.to("meta"), q, 0, 0, True, 1.0)


@pytest.mark.parametrize("causal", [True, False])
def test_head_dim_padding_changes_no_result(causal):
    """The bf16 forward kernel takes a head dim that is not a multiple of
    8 on copies zero-padded by ``_pad_head_dim``: the plain forward gives
    the same m and l at d = 100 as at its padding to d = 104, the same pv
    in the first d columns (within 1e-6: the same sums with zeros added)
    and zeros in the padding."""
    bh, sq, sk, d, d_pad = 2, 70, 90, 100, 104
    rng = np.random.default_rng(17 + causal)
    q, k, v = (
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        for shape in ((bh, sq, d), (bh, sk, d), (bh, sk, d))
    )
    scale = 1.0 / np.sqrt(d)
    args = (5, 0, causal, scale, sq, sk)
    want = tfa.attend_partials_plain(q, k, v, *args)
    q_p, k_p, v_p = (tfa._pad_head_dim(t, d_pad) for t in (q, k, v))
    assert q_p.is_contiguous() and torch.equal(q_p[..., :d], q) and not q_p[..., d:].any()
    pv, m, l = tfa.attend_partials_plain(q_p, k_p, v_p, *args)
    assert pv.shape[-1] == d_pad and not pv[..., d:].any()
    for g, w, name in ((pv[..., :d], want[0], "pv"), (m, want[1], "m"), (l, want[2], "l")):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-6, err_msg=name)
