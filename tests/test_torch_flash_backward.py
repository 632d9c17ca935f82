"""The port's flash-attention gradient (``_DiffPartials``: the plain
version of K4/K5 plus the g_m term on their argmax) against the JAX
package's Pallas backward, run in interpret mode on the CPU as
tests/test_flash_attention.py runs it, and the port's ring-attention
gradient against the JAX ring attention's on a one-device mesh.

f32 inputs and cotangents for (pv, m, l) from a seeded numpy generator;
tolerance atol = rtol = 2e-4, as the JAX package's own backward parity
test uses (the same products summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from torchsnapshot_tpu import knobs as jknobs
from torchsnapshot_tpu.ops.flash_attention import (
    PALLAS_AVAILABLE,
    flash_attention_partials as jax_partials,
)
from torchsnapshot_tpu.parallel.ring_attention import ring_attention as jax_ring_attention
from torchsnapshot_tpu_torch.ops import flash_attention as tfa
from torchsnapshot_tpu_torch.parallel.ring_attention import ring_attention

TOL = dict(rtol=2e-4, atol=2e-4)

pytestmark = pytest.mark.skipif(not PALLAS_AVAILABLE, reason="pallas unavailable")


def _arrays(rng, *shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax_grads(q, k, v, cts, qo, ko, causal, scale):
    """The JAX package's vjp of flash_attention_partials with its Pallas
    backward (interpret mode on the CPU)."""

    def partials(q, k, v):
        pv, m, l, _ = jax_partials(q, k, v, qo, ko, causal, scale)
        return pv, m, l

    with jknobs.override_pallas_attention("1"):
        _, vjp = jax.vjp(partials, *(jnp.asarray(x) for x in (q, k, v)))
        return [np.asarray(g) for g in vjp(tuple(jnp.asarray(c) for c in cts))]


def _port_grads(q, k, v, cts, qo, ko, causal, scale):
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    pv, m, l, valid = tfa.flash_attention_partials(q, k, v, qo, ko, causal, scale)
    assert not valid.requires_grad
    return torch.autograd.grad((pv, m, l), (q, k, v), [torch.from_numpy(c) for c in cts])


def _check(got, want):
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("offsets", [(0, 0), (256, 128)])
def test_partials_gradient_matches_pallas_backward(causal, offsets):
    b, sq, sk, h, d = 1, 128, 192, 2, 32
    rng = np.random.default_rng(sq + offsets[0] + causal)
    q, k, v = _arrays(rng, (b, sq, h, d), (b, sk, h, d), (b, sk, h, d))
    cts = _arrays(rng, (b, sq, h, d), (b, h, sq), (b, h, sq))
    args = (*offsets, causal, 0.125)
    _check(_port_grads(q, k, v, cts, *args), _jax_grads(q, k, v, cts, *args))


def test_ragged_partials_gradient_matches_pallas_backward():
    """Lengths that divide no block size: the padded rows and columns of
    the Pallas kernels must contribute nothing, as the port masks them."""
    b, sq, sk, h, d = 1, 200, 136, 2, 48
    rng = np.random.default_rng(11)
    q, k, v = _arrays(rng, (b, sq, h, d), (b, sk, h, d), (b, sk, h, d))
    cts = _arrays(rng, (b, sq, h, d), (b, h, sq), (b, h, sq))
    args = (0, 0, True, 0.2)
    _check(_port_grads(q, k, v, cts, *args), _jax_grads(q, k, v, cts, *args))


def test_m_cotangent_lands_on_the_first_tied_column():
    """Two identical key rows tie every row's max.  The JAX backward puts
    the g_m cotangent on the first argmax column; torch's ``amax``
    subgradient would split it over the ties, so dk differs unless the
    port follows the JAX contract."""
    b, sq, sk, h, d = 1, 64, 48, 1, 16
    rng = np.random.default_rng(5)
    q, k, v = _arrays(rng, (b, sq, h, d), (b, sk, h, d), (b, sk, h, d))
    k[:, 20] = k[:, 7] = 3.0 * np.abs(q).max(axis=1)  # the dominant key, twice
    cts = _arrays(rng, (b, sq, h, d), (b, h, sq), (b, h, sq))
    args = (0, 0, False, 0.25)
    got = _port_grads(q, k, v, cts, *args)
    want = _jax_grads(q, k, v, cts, *args)
    assert np.abs(want[1][:, 7] - want[1][:, 20]).max() > 1e-2  # the tie is not split
    _check(got, want)


@pytest.mark.parametrize("causal", [True, False])
def test_head_dim_padding_changes_no_result(causal):
    """The bf16 kernels take a head dim that is not a multiple of 8 on
    copies zero-padded by ``_pad_head_dim``: the plain backward gives the
    same dq, dk, dv and amax at d = 100 as at its padding to d = 104 with
    the padding cut from the outputs (amax exactly, the rest within
    1e-6: the same sums with zeros added), and zeros in the padding."""
    bh, sq, sk, d, d_pad = 2, 70, 90, 100, 104
    rng = np.random.default_rng(7 + causal)
    q, k, v, gpv = (
        torch.from_numpy(x) for x in _arrays(rng, (bh, sq, d), (bh, sk, d), (bh, sk, d), (bh, sq, d))
    )
    gl = torch.from_numpy(_arrays(rng, (bh, sq))[0])
    scale = 1.0 / np.sqrt(d)
    _, m, _ = tfa.attend_partials_plain(q, k, v, 5, 0, causal, scale, sq, sk)
    m = torch.where(torch.isfinite(m), m, 0.0)
    args = (5, 0, causal, scale, sq, sk)
    want = tfa.flash_bwd_plain(q, k, v, m, gpv, gl, *args)
    q_p, k_p, v_p, gpv_p = (tfa._pad_head_dim(t, d_pad) for t in (q, k, v, gpv))
    assert q_p.is_contiguous() and torch.equal(q_p[..., :d], q) and not q_p[..., d:].any()
    got = tfa.flash_bwd_plain(q_p, k_p, v_p, m, gpv_p, gl, *args)
    assert torch.equal(got[3], want[3])
    for g, w, name in zip(got[:3], want[:3], ("dq", "dk", "dv")):
        assert g.shape[-1] == d_pad and not g[..., d:].any(), name
        np.testing.assert_allclose(g[..., :d].numpy(), w.numpy(), rtol=1e-6, atol=1e-6, err_msg=name)


def test_ring_attention_gradient_matches_jax_ring_attention():
    b, s, h, d = 1, 96, 2, 16
    rng = np.random.default_rng(3)
    q, k, v = _arrays(rng, (b, s, h, d), (b, s, h, d), (b, s, h, d))
    ct = _arrays(rng, (b, s, h, d))[0]
    mesh = Mesh(np.array(jax.devices()[:1]), ("sp",))

    def loss(q, k, v):
        return jnp.sum(jax_ring_attention(q, k, v, mesh, causal=True) * ct)

    with jknobs.override_pallas_attention("1"):
        want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ring_attention(tq, tk, tv, causal=True)
    got = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), (tq, tk, tv))
    _check(got, [np.asarray(w) for w in want])
