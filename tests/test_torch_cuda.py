"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips, with the reason, where
``torch.cuda.is_available()`` is false.  On a machine with the card:
``python -m pytest tests/test_torch_cuda.py -q``.  Tolerances: K1 and K2
bitwise; K3 m atol 1e-3 and pv/l compared after normalisation within
2e-2 for bf16 inputs (bf16 operands, another summation order), 1e-4 for
f32 ones.  K4/K5 (dq, dk, dv) within 2e-2 (bf16: ds and gpv enter the
tensor cores in bf16) or 1e-4 (f32) of the largest plain value; the
argmax exactly, on rows whose top two scores are apart by more than the
summation order can move them; two calls on the same inputs bitwise
equal (no float atomics, for K3 too).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _misses(family):
    """The registry's counts of one miss family, by reason."""
    import torchsnapshot_tpu_torch as tts

    prefix = family + "."
    return {k[len(prefix):]: v for k, v in tts.obs.counters().items() if k.startswith(prefix)}


def _pinned_gauge():
    """Pinned read buffers in use; ``max`` is the high-water mark."""
    import torchsnapshot_tpu_torch as tts

    return tts.obs.gauge(tts.obs.READ_PINNED_IN_USE)


def _rand(shape, dtype, device, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype).to(device)


def test_slab_pack_matches_plain(cuda):
    from torchsnapshot_tpu_torch.ops import device_pack as dp

    members = [
        _rand((3,), torch.float32, cuda, 0) > 0,  # 3 bytes: later members misalign
        _rand((257, 129), torch.bfloat16, cuda, 1),
        _rand((4096,), torch.float32, cuda, 2),
        _rand((7, 5), torch.float64, cuda, 3).t(),  # non-contiguous
        torch.empty(0, device=cuda),
        _rand((100000,), torch.float16, cuda, 4),
    ]
    before = dp.LAUNCHES["slab_pack"]
    got = dp.pack_slab(members)
    assert dp.LAUNCHES["slab_pack"] == before + 1
    assert torch.equal(got.cpu(), dp.pack_slab_plain([m.cpu() for m in members]))


def test_slab_unpack_matches_plain(cuda):
    from torchsnapshot_tpu_torch.ops import device_pack as dp
    from torchsnapshot_tpu_torch.serialization import dtype_to_string

    src = [
        _rand((3,), torch.float32, cuda, 5) > 0,
        _rand((300, 77), torch.bfloat16, cuda, 6),
        _rand((1000,), torch.float32, cuda, 7),
        (_rand((999,), torch.float32, cuda, 8) * 1000).to(torch.int32),
        _rand((5, 5), torch.float16, cuda, 9),
    ]
    out_dtypes = [torch.bool, torch.float32, torch.bfloat16, torch.int64, torch.float16]
    slab = dp.pack_slab_plain([t.cpu() for t in src]).to(cuda)
    members, off = [], 0
    for t in src:
        members.append((off, dtype_to_string(t.dtype), tuple(t.shape)))
        off += t.numel() * t.element_size()
    outs = [torch.empty(t.shape, dtype=d, device=cuda) for t, d in zip(src, out_dtypes)]
    dp.unpack_slab_into(slab, members, outs)
    want = dp.unpack_slab_plain(slab, members, out_dtypes)
    for o, w in zip(outs, want):
        assert o.dtype == w.dtype and torch.equal(o, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "sq,sk,q_offset,k_offset,causal",
    [(256, 256, 0, 0, True), (200, 190, 0, 0, True), (128, 256, 384, 128, True),
     (96, 160, 0, 0, False)],
)
def test_flash_partials_match_plain(cuda, dtype, sq, sk, q_offset, k_offset, causal):
    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    bh, d = 4, 128
    q, k, v = (_rand((bh, n, d), dtype, cuda, s) for n, s in ((sq, 10), (sk, 11), (sk, 12)))
    scale = 1.0 / np.sqrt(d)
    pv, m, l = fa.attend_partials(q, k, v, q_offset, k_offset, causal, scale)
    wpv, wm, wl = fa.attend_partials_plain(q, k, v, q_offset, k_offset, causal, scale, sq, sk)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    finite = torch.isfinite(wm)
    assert torch.equal(torch.isfinite(m), finite)
    torch.testing.assert_close(m[finite], wm[finite], atol=1e-3, rtol=0)
    denom = lambda x: torch.where(x == 0, 1.0, x)[..., None]  # noqa: E731
    torch.testing.assert_close(pv / denom(l), wpv / denom(wl), atol=tol, rtol=tol)
    torch.testing.assert_close(l, wl, atol=tol, rtol=tol)


@pytest.mark.parametrize("d", [64, 100])
def test_flash_partials_other_head_dims(cuda, d):
    """bf16 d = 100 runs the kernel on copies padded to d = 104."""
    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    bh, sq, sk = 3, 150, 170
    q, k, v = (_rand((bh, n, d), torch.bfloat16, cuda, s) for n, s in ((sq, 20), (sk, 21), (sk, 22)))
    scale = 1.0 / np.sqrt(d)
    pv, m, l = fa.attend_partials(q, k, v, 40, 0, True, scale)
    wpv, wm, wl = fa.attend_partials_plain(q, k, v, 40, 0, True, scale, sq, sk)
    torch.cuda.synchronize()
    finite = torch.isfinite(wm)
    assert torch.equal(torch.isfinite(m), finite)
    torch.testing.assert_close(m[finite], wm[finite], atol=1e-3, rtol=0)
    denom = lambda x: torch.where(x == 0, 1.0, x)[..., None]  # noqa: E731
    torch.testing.assert_close(pv / denom(l), wpv / denom(wl), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(l, wl, atol=2e-2, rtol=2e-2)


def _check_fwd(got, want, tol=2e-2):
    pv, m, l = got
    wpv, wm, wl = want
    finite = torch.isfinite(wm)
    assert torch.equal(torch.isfinite(m), finite)
    torch.testing.assert_close(m[finite], wm[finite], atol=1e-3, rtol=0)
    denom = lambda x: torch.where(x == 0, 1.0, x)[..., None]  # noqa: E731
    torch.testing.assert_close(pv / denom(l), wpv / denom(wl), atol=tol, rtol=tol)
    torch.testing.assert_close(l, wl, atol=tol, rtol=tol)


@pytest.mark.parametrize(
    "sq,sk,q_offset,k_offset,causal,d",
    [(1, 200, 199, 0, True, 128),  # a one-row q
     (129, 257, 128, 0, True, 128), (257, 129, 0, 0, True, 128),  # just past a 128-row tile
     (96, 160, 0, 0, False, 64),  # non-causal at d = 64
     (128, 256, 384, 128, True, 128)],  # q and k offsets
)
def test_flash_fwd_edges_match_plain(cuda, sq, sk, q_offset, k_offset, causal, d):
    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    q, k, v = (_rand((4, n, d), torch.bfloat16, cuda, sq + i) for i, n in enumerate((sq, sk, sk)))
    scale = 1.0 / np.sqrt(d)
    before = fa.LAUNCHES["flash_fwd"]
    got = fa.attend_partials(q, k, v, q_offset, k_offset, causal, scale)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_fwd"] == before + 1
    _check_fwd(got, fa.attend_partials_plain(q, k, v, q_offset, k_offset, causal, scale, sq, sk))


def test_flash_fwd_rows_that_see_nothing(cuda):
    """A k_offset that leaves the first 50 q rows seeing no column, and
    sk_real < sk: those rows have m = -inf, l = 0 and pv = 0."""
    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    sq, sk, sk_real, k_offset = 100, 150, 90, 50
    q, k, v = (_rand((3, n, 128), torch.bfloat16, cuda, 60 + i) for i, n in enumerate((sq, sk, sk)))
    got = fa.attend_partials(q, k, v, 0, k_offset, True, 0.1, sq_real=sq, sk_real=sk_real)
    torch.cuda.synchronize()
    pv, m, l = got
    assert bool(torch.isneginf(m[:, :50]).all()) and bool((l[:, :50] == 0).all())
    assert bool((pv[:, :50] == 0).all()) and bool(torch.isfinite(m[:, 50:]).all())
    _check_fwd(got, fa.attend_partials_plain(q, k, v, 0, k_offset, True, 0.1, sq, sk_real))


def test_flash_fwd_more_blocks_than_one_wave_and_bitwise_repeat(cuda):
    """bh = 64 at s = 512: 256 blocks of 128 rows, about two waves on a
    132-SM card with one block per SM; a second call gives the same bits."""
    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    q, k, v = (_rand((64, 512, 128), torch.bfloat16, cuda, 70 + i) for i in range(3))
    first = fa.attend_partials(q, k, v, 0, 0, True, 0.09)
    second = fa.attend_partials(q, k, v, 0, 0, True, 0.09)
    torch.cuda.synchronize()
    for a, b, name in zip(first, second, ("pv", "m", "l")):
        assert torch.equal(a, b), name
    _check_fwd(first, fa.attend_partials_plain(q, k, v, 0, 0, True, 0.09, 512, 512))


@pytest.mark.parametrize("case", ["d100", "misaligned", "d128"])
def test_flash_fwd_pads_what_tma_cannot_read(cuda, case):
    """A head dim that is not a multiple of 8, or a q base that is not
    16-byte aligned, runs the bf16 kernel on zero-padded copies, counted
    in ``PADDED``; d = 128 with aligned bases runs as it is."""
    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    d = 100 if case == "d100" else 128
    sq, sk = 70, 90
    q, k, v = (_rand((2, n, d), torch.bfloat16, cuda, 90 + i) for i, n in enumerate((sq, sk, sk)))
    if case == "misaligned":  # the same values one element into a larger buffer
        buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
        buf[1:] = q.reshape(-1)
        q = buf[1:].view(q.shape)
        assert q.is_contiguous() and q.data_ptr() % 16
    before = fa.PADDED["flash_fwd"]
    got = fa.attend_partials(q, k, v, 0, 0, True, 0.1)
    torch.cuda.synchronize()
    assert fa.PADDED["flash_fwd"] == before + int(case != "d128")
    assert got[0].shape == (2, sq, d)
    _check_fwd(got, fa.attend_partials_plain(q, k, v, 0, 0, True, 0.1, sq, sk))


def _byte_members(cuda, sizes, src_shift, seed):
    """uint8 members of ``sizes`` bytes cut out of one buffer at source
    offsets ``src_shift`` mod 16."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    stride = -(-max(sizes) // 16) * 16 + 16
    buf = torch.randint(0, 256, (stride * len(sizes) + 16,), dtype=torch.uint8, generator=g).to(cuda)
    return [buf[j * stride + src_shift:j * stride + src_shift + n] for j, n in enumerate(sizes)]


@pytest.mark.parametrize("src_shift", range(16))
def test_slab_pack_any_alignment(cuda, src_shift):
    """Members whose sources sit at ``src_shift`` mod 16 and whose slab
    offsets take every value mod 16 (sizes 1 to 65,537 bytes, several
    larger than a chunk), bitwise against the plain version."""
    from torchsnapshot_tpu_torch.ops import device_pack as dp

    sizes = [1, 15, 16, 0, 17, 4, 4099, 32767, 32768, 32769, 65537, 3, 48, 100000, 2, 4]
    members = _byte_members(cuda, sizes, src_shift, src_shift)
    assert len({m.data_ptr() % 16 for m in members if m.numel()}) == 1
    got = dp.pack_slab(members)
    assert torch.equal(got.cpu(), dp.pack_slab_plain([m.cpu() for m in members]))


def test_slab_pack_table_longer_than_the_launch_carries(cuda):
    """More members than fit in the kernel's parameters: the table is
    uploaded, and the slab is the same."""
    from torchsnapshot_tpu_torch.ops import device_pack as dp
    from torchsnapshot_tpu_torch.ops import kernels

    n = kernels.lib("slab_pack").tsnp_slab_pack_inline_members() + 80
    sizes = [int(x) for x in np.random.default_rng(3).integers(0, 3000, n)]
    members = _byte_members(cuda, sizes, 5, 7)
    got = dp.pack_slab(members)
    assert torch.equal(got.cpu(), dp.pack_slab_plain([m.cpu() for m in members]))


def test_slab_unpack_identity_members_at_misaligned_offsets(cuda):
    """Identity members at every slab offset mod 16 (after 4-byte
    scalars and odd-sized members) land bitwise in aligned templates."""
    from torchsnapshot_tpu_torch.ops import device_pack as dp
    from torchsnapshot_tpu_torch.serialization import dtype_to_string

    src = []
    for i, (shape, dtype) in enumerate([((33, 65), torch.bfloat16), ((), torch.float32),
                                        ((4099,), torch.bool), ((70000,), torch.float32),
                                        ((1,), torch.uint8), ((129, 257), torch.bfloat16),
                                        ((), torch.float32), ((5000,), torch.int64)]):
        t = _rand(shape, torch.float32, cuda, 100 + i) * 1000
        src.append(t > 0 if dtype == torch.bool else t.to(dtype))
    slab = dp.pack_slab_plain([t.cpu() for t in src]).to(cuda)
    members, off = [], 0
    for t in src:
        members.append((off, dtype_to_string(t.dtype), tuple(t.shape)))
        off += t.numel() * t.element_size()
    assert len({o % 16 for o, _, _ in members}) > 4
    outs = [torch.empty_like(t) for t in src]
    dp.unpack_slab_into(slab, members, outs)
    for o, t in zip(outs, src):
        assert torch.equal(o, t)


def _bwd_inputs(bh, sq, sk, d, dtype, device, q_offset, k_offset, causal, seed):
    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    q, k, v = (_rand((bh, n, d), dtype, device, seed + i) for i, n in enumerate((sq, sk, sk)))
    scale = 1.0 / np.sqrt(d)
    _, m, _ = fa.attend_partials_plain(q, k, v, q_offset, k_offset, causal, scale, sq, sk)
    m = torch.where(torch.isfinite(m), m, 0.0).contiguous()
    gpv = _rand((bh, sq, d), torch.float32, device, seed + 3)
    gl = _rand((bh, sq), torch.float32, device, seed + 4)
    return q, k, v, m, gpv, gl, scale


def _check_bwd(got, want, q, k, scale, q_offset, k_offset, causal, sq_real, sk_real, dtype):
    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    dq, dk, dv, amax = got
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for g, ref, name in zip((dq, dk, dv), want[:3], ("dq", "dk", "dv")):
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), name
        torch.testing.assert_close(g, ref, rtol=tol, atol=tol * max(float(ref.abs().max()), 1e-6), msg=name)
    # rows whose argmax the summation order cannot move must agree exactly
    sq, sk = q.shape[1], k.shape[1]
    mask = fa._visible(sq, sk, q_offset, k_offset, causal, sq_real, sk_real, q.device)
    scores = fa._scores(q, k, scale, mask)
    top = scores.topk(min(2, sk), dim=-1).values
    clear = (top[..., 0] - top[..., -1] > 1e-2 * (1 + top[..., 0].abs())) | ~torch.isfinite(top[..., -1])
    assert torch.equal(amax[clear], want[3][clear])
    assert torch.equal(amax == -1, want[3] == -1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "sq,sk,q_offset,k_offset,causal,d",
    [(256, 256, 0, 0, True, 128), (200, 190, 0, 0, True, 128), (128, 256, 384, 128, True, 128),
     (96, 160, 0, 0, False, 128), (150, 170, 40, 0, True, 100), (64, 64, 0, 4096, True, 64),
     # a one-row q; sq and sk just past a 128-row tile; non-causal at d = 64
     (1, 200, 199, 0, True, 128), (129, 257, 128, 0, True, 128), (257, 129, 0, 0, True, 128),
     (96, 160, 0, 0, False, 64)],
)
def test_flash_bwd_matches_plain(cuda, dtype, sq, sk, q_offset, k_offset, causal, d):
    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    q, k, v, m, gpv, gl, scale = _bwd_inputs(4, sq, sk, d, dtype, cuda, q_offset, k_offset, causal, sq + d)
    before = dict(fa.LAUNCHES)
    got = fa.flash_bwd(q, k, v, m, gpv, gl, q_offset, k_offset, causal, scale)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert fa.LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    want = fa.flash_bwd_plain(q, k, v, m, gpv, gl, q_offset, k_offset, causal, scale, sq, sk)
    _check_bwd(got, want, q, k, scale, q_offset, k_offset, causal, sq, sk, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_fully_masked_rows(cuda, dtype):
    """sk_real < sk, and a k_offset that leaves the first 50 q rows seeing
    no column: their amax is −1 and their dq zero."""
    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    sq, sk, sk_real, k_offset = 100, 150, 90, 50
    q, k, v, m, gpv, gl, scale = _bwd_inputs(3, sq, sk, 128, dtype, cuda, 0, k_offset, True, 60)
    _, m, _ = fa.attend_partials_plain(q, k, v, 0, k_offset, True, scale, sq, sk_real)
    m = torch.where(torch.isfinite(m), m, 0.0).contiguous()
    got = fa.flash_bwd(q, k, v, m, gpv, gl, 0, k_offset, True, scale, sq_real=sq, sk_real=sk_real)
    torch.cuda.synchronize()
    want = fa.flash_bwd_plain(q, k, v, m, gpv, gl, 0, k_offset, True, scale, sq, sk_real)
    assert bool((got[3][:, :50] == -1).all()) and bool((got[0][:, :50] == 0).all())
    assert bool((got[1][:, sk_real:] == 0).all()) and bool((got[2][:, sk_real:] == 0).all())
    _check_bwd(got, want, q, k, scale, 0, k_offset, True, sq, sk_real, dtype)


def test_flash_bwd_more_blocks_than_one_wave(cuda):
    """bh = 64 at s = 512: 256 blocks of 128 rows per kernel, about two
    waves on a 132-SM card with one block per SM."""
    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    bh, s, d = 64, 512, 128
    q, k, v, m, gpv, gl, scale = _bwd_inputs(bh, s, s, d, torch.bfloat16, cuda, 0, 0, True, 70)
    got = fa.flash_bwd(q, k, v, m, gpv, gl, 0, 0, True, scale)
    torch.cuda.synchronize()
    want = fa.flash_bwd_plain(q, k, v, m, gpv, gl, 0, 0, True, scale, s, s)
    _check_bwd(got, want, q, k, scale, 0, 0, True, s, s, torch.bfloat16)


def test_flash_bwd_is_bitwise_repeatable(cuda):
    """No float atomics: two calls on the same inputs give the same bits."""
    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    q, k, v, m, gpv, gl, scale = _bwd_inputs(8, 300, 280, 128, torch.bfloat16, cuda, 20, 0, True, 80)
    first = fa.flash_bwd(q, k, v, m, gpv, gl, 20, 0, True, scale)
    second = fa.flash_bwd(q, k, v, m, gpv, gl, 20, 0, True, scale)
    torch.cuda.synchronize()
    for a, b, name in zip(first, second, ("dq", "dk", "dv", "amax")):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("d,padded", [(100, True), (128, False)])
def test_flash_bwd_pads_what_tma_cannot_read(cuda, d, padded):
    """A head dim that is not a multiple of 8 runs the bf16 kernels on
    zero-padded copies, counted in ``PADDED``; d = 128 runs as it is."""
    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    q, k, v, m, gpv, gl, scale = _bwd_inputs(2, 70, 90, d, torch.bfloat16, cuda, 0, 0, True, 90)
    before = fa.PADDED["flash_bwd"]
    got = fa.flash_bwd(q, k, v, m, gpv, gl, 0, 0, True, scale)
    torch.cuda.synchronize()
    assert fa.PADDED["flash_bwd"] == before + int(padded)
    assert all(t.shape[-1] == d for t in got[:3])
    want = fa.flash_bwd_plain(q, k, v, m, gpv, gl, 0, 0, True, scale, 70, 90)
    _check_bwd(got, want, q, k, scale, 0, 0, True, 70, 90, torch.bfloat16)


def test_ring_attention_gradient_flows_through_the_kernels(cuda):
    """A loss through ring attention on CUDA tensors reaches q, k and v
    through K4/K5 (K3's ctypes launch alone has no autograd graph), and
    matches the gradient of f32 dense attention."""
    from torchsnapshot_tpu_torch.ops import flash_attention as fa
    from torchsnapshot_tpu_torch.parallel.ring_attention import dense_attention, ring_attention

    b, s, h, d = 1, 384, 4, 128
    q, k, v = (_rand((b, s, h, d), torch.bfloat16, cuda, 30 + i).requires_grad_() for i in range(3))
    ct = _rand((b, s, h, d), torch.float32, cuda, 33)
    before = dict(fa.LAUNCHES)
    grads = torch.autograd.grad((ring_attention(q, k, v, causal=True).float() * ct).sum(), (q, k, v))
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_bwd_dq"] > before["flash_bwd_dq"]
    assert fa.LAUNCHES["flash_bwd_dkv"] > before["flash_bwd_dkv"]
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad((dense_attention(qf, kf, vf, causal=True) * ct).sum(), (qf, kf, vf))
    for g, w, name in zip(grads, want, "qkv"):
        assert g is not None and g.dtype == torch.bfloat16, name
        torch.testing.assert_close(g.float(), w, rtol=3e-2, atol=3e-2 * float(w.abs().max()), msg=f"d{name}")


# the blocks of a causal ring of two ranks of s positions each: rank 0 at
# step 1 (wholly above the diagonal), rank 1 at step 0 (the diagonal at
# offset s), rank 1 at step 1 (no mask)
_RING_BLOCKS = {"masked": (0, 1), "diag": (1, 1), "unmasked": (1, 0)}


@pytest.mark.parametrize("block", sorted(_RING_BLOCKS))
def test_flash_kernels_at_the_rings_key_offsets(cuda, block):
    """K3, K4 and K5 on the ring's own blocks at s = 512 (bf16, causal)
    against their plain versions, a second call bitwise equal; the wholly
    masked block gives zeros, m = -inf and argmax -1 everywhere."""
    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    s, d = 512, 128
    qo, ko = (s * i for i in _RING_BLOCKS[block])
    q, k, v, m, gpv, gl, scale = _bwd_inputs(4, s, s, d, torch.bfloat16, cuda, qo, ko, True, 100)
    pv, mm, l = fa.attend_partials(q, k, v, qo, ko, True, scale)
    wpv, wm, wl = fa.attend_partials_plain(q, k, v, qo, ko, True, scale, s, s)
    again = fa.attend_partials(q, k, v, qo, ko, True, scale)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip((pv, mm, l), again))
    finite = torch.isfinite(wm)
    assert torch.equal(torch.isfinite(mm), finite)
    torch.testing.assert_close(mm[finite], wm[finite], atol=1e-3, rtol=0)
    denom = lambda x: torch.where(x == 0, 1.0, x)[..., None]  # noqa: E731
    torch.testing.assert_close(pv / denom(l), wpv / denom(wl), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(l, wl, atol=2e-2, rtol=2e-2)
    got = fa.flash_bwd(q, k, v, m, gpv, gl, qo, ko, True, scale)
    second = fa.flash_bwd(q, k, v, m, gpv, gl, qo, ko, True, scale)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, second))
    want = fa.flash_bwd_plain(q, k, v, m, gpv, gl, qo, ko, True, scale, s, s)
    if block == "masked":
        assert not bool(finite.any()) and not bool(pv.any()) and not bool(l.any())
        assert not any(bool(t.any()) for t in got[:3]) and bool((got[3] == -1).all())
    else:
        _check_bwd(got, want, q, k, scale, qo, ko, True, s, s, torch.bfloat16)


def test_ring_attention_over_two_ranks_on_the_card(cuda, tmp_path):
    """Two processes on the card over gloo (the exchanges staged through
    pinned host memory), ring size 2, bf16, causal: each rank's output
    within 2e-2 of f32 dense attention over both shards, the gradients
    of q, k and v within 3e-2 of the largest dense gradient, and K3, K4
    and K5 launched on both ranks."""
    import os
    import socket
    import subprocess
    import sys
    import textwrap

    from torchsnapshot_tpu_torch.parallel.ring_attention import dense_attention

    b, s, h, d = 1, 256, 4, 128
    q, k, v, ct = (_rand((b, 2 * s, h, d), dt, cuda, 40 + i) for i, dt in
                   enumerate((torch.bfloat16, torch.bfloat16, torch.bfloat16, torch.float32)))
    torch.save({"q": q.cpu(), "k": k.cpu(), "v": v.cpu(), "ct": ct.cpu()}, tmp_path / "in.pt")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "ring.py"
    script.write_text(textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {repo!r})
        import torch
        import torch.distributed as dist
        from torchsnapshot_tpu_torch.ops import flash_attention as fa
        from torchsnapshot_tpu_torch.parallel.ring_attention import ring_attention
        rank = int(sys.argv[1])
        dist.init_process_group("gloo", init_method="tcp://127.0.0.1:{port}", rank=rank, world_size=2)
        t = torch.load({str(tmp_path / "in.pt")!r})
        cut = slice(rank * {s}, (rank + 1) * {s})
        q, k, v = (t[n][:, cut].cuda().contiguous().requires_grad_() for n in "qkv")
        out = ring_attention(q, k, v, causal=True)
        grads = torch.autograd.grad((out.float() * t["ct"][:, cut].cuda()).sum(), (q, k, v))
        torch.cuda.synchronize()
        assert all(fa.LAUNCHES[n] > 0 for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")), fa.LAUNCHES
        torch.save({{"out": out.detach().cpu(), **{{f"d{{n}}": g.cpu() for n, g in zip("qkv", grads)}}}},
                   {str(tmp_path)!r} + f"/out{{rank}}.pt")
        dist.destroy_process_group()
        """))
    procs = [subprocess.Popen([sys.executable, str(script), str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), outs
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    dense = dense_attention(qf, kf, vf, causal=True)
    want = torch.autograd.grad((dense * ct).sum(), (qf, kf, vf))
    for r in range(2):
        got = torch.load(tmp_path / f"out{r}.pt")
        cut = slice(r * s, (r + 1) * s)
        torch.testing.assert_close(got["out"].cuda().float(), dense[:, cut].detach(), atol=2e-2, rtol=2e-2)
        for n, w in zip("qkv", want):
            torch.testing.assert_close(got[f"d{n}"].cuda().float(), w[:, cut], rtol=3e-2,
                                       atol=3e-2 * float(w.abs().max()), msg=f"rank {r} d{n}")


@pytest.mark.parametrize("budget", ["device", "blocking", "staged"])
def test_async_take_of_cuda_tensors_mutated_after_return(cuda, tmp_path, monkeypatch, budget):
    """CUDA tensors (slab members and one tensor outside any slab) and a
    host step counter, all changed in place right after async_take
    returns, restore to their values at async_take — through device
    copies, with no device budget through host copies made before the
    return, or with eager staging disabled through staging finished
    before the return."""
    import contextlib

    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch import host_offload
    from torchsnapshot_tpu_torch import knobs

    if budget == "blocking":
        monkeypatch.setattr(host_offload, "device_copy_budget_bytes", lambda device: 0)
    host_offload.LAST_OFFLOAD_STATS.clear()
    state = tts.StateDict(
        small=[_rand((300, 77), torch.bfloat16, cuda, 40 + i) for i in range(4)],
        big=_rand((1 << 20,), torch.float32, cuda, 45),
        step=torch.tensor(5.0),
    )
    want = {"small": [t.clone() for t in state["small"]], "big": state["big"].clone(),
            "step": state["step"].clone()}
    staged = knobs.override_disable_eager_host_staging(True) if budget == "staged" else contextlib.nullcontext()
    with knobs.override_slab_size_threshold_bytes(1 << 20), staged:
        pending = tts.Snapshot.async_take(str(tmp_path), {"app": state})
    for t in state["small"]:
        t.mul_(-3)
    state["big"].add_(1)
    state["step"] += 1
    pending.wait()
    stats = dict(host_offload.LAST_OFFLOAD_STATS)
    if budget == "staged":
        assert stats == {}, stats  # no eager copies: staging ran before the return
    else:
        key = "device_copy_bytes" if budget == "device" else "blocking_host_bytes"
        assert stats[key] >= 4 * 300 * 77 * 2 + (1 << 22), stats
    out = tts.StateDict(
        small=[torch.zeros_like(t) for t in want["small"]],
        big=torch.zeros_like(want["big"]), step=torch.tensor(0.0),
    )
    tts.Snapshot(str(tmp_path)).restore({"app": out})
    for got, ref in zip(out["small"], want["small"]):
        assert torch.equal(got, ref)
    assert torch.equal(out["big"], want["big"]) and torch.equal(out["step"], want["step"])


def test_device_copies_take_a_pool_of_their_own_and_give_it_back(cuda, tmp_path):
    """An async take's device copies come from a memory pool of their own:
    they leave the free blocks the caching allocator keeps for the next
    step where they are, and the pool's memory goes back to the device
    once the snapshot is committed and the copies are gone."""
    import gc

    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch import host_offload

    state = tts.StateDict(w=[_rand((1 << 22,), torch.float32, cuda, 50 + i) for i in range(4)])
    device = state["w"][0].device
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_reserved()
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=cuda)
    del scratch  # 256 MiB of free cached blocks, as a step leaves them
    before = torch.cuda.memory_reserved()
    pending = tts.Snapshot.async_take(str(tmp_path), {"app": state})
    assert host_offload.LAST_OFFLOAD_STATS["device_copy_bytes"] == 4 << 24
    assert torch.cuda.memory_reserved() >= before + (4 << 24)  # new segments, not the cache
    assert host_offload._LIVE_COPY_BYTES[device] >= 4 << 24
    pending.wait()
    del pending
    gc.collect()
    assert host_offload._LIVE_COPY_BYTES[device] == 0
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() <= base


_K6_DTYPES = [torch.float16, torch.bfloat16, torch.float32, torch.float64, torch.int8,
              torch.int16, torch.int32, torch.int64, torch.uint8]
_K6_PAIRS = [
    (a, b) for a in _K6_DTYPES for b in _K6_DTYPES
    if a.is_floating_point == b.is_floating_point
] + [(torch.bool, torch.bool), (torch.complex64, torch.complex64)]


def _tile_of(dtype, n, device, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    if dtype.is_floating_point:
        return (torch.randn(n, generator=g) * 1000).to(dtype).to(device)
    if dtype == torch.bool:
        return (torch.rand(n, generator=g) > 0.5).to(device)
    if dtype == torch.complex64:
        return torch.randn(n, generator=g, dtype=torch.complex64).to(device)
    lo, hi = (0, 256) if dtype == torch.uint8 else (-(2**31), 2**31)
    return torch.randint(lo, hi, (n,), generator=g, dtype=torch.int64).to(dtype).to(device)


@pytest.mark.parametrize("src,dst", _K6_PAIRS, ids=lambda d: str(d).replace("torch.", ""))
def test_tile_update_matches_plain_for_every_pair(cuda, src, dst):
    """K6 at an odd offset with a ragged tile, bitwise against its plain
    version; the rest of the template untouched."""
    from torchsnapshot_tpu_torch.ops import device_pack as dp

    tile = _tile_of(src, 70001, cuda, 60)
    base = _tile_of(dst, 100003, cuda, 61)
    got, want = base.clone(), base.clone()
    before = dp.LAUNCHES["tile_update"]
    dp.tile_update(got, 12345, tile)
    torch.cuda.synchronize()
    assert dp.LAUNCHES["tile_update"] == before + 1
    dp.tile_update_plain(want, 12345, tile)
    assert torch.equal(got, want)


def test_tile_update_one_element_and_multi_d_template(cuda):
    from torchsnapshot_tpu_torch.ops import device_pack as dp

    dst = torch.zeros((3, 5, 7), dtype=torch.float32, device=cuda)
    tile = torch.tensor([2.5], dtype=torch.bfloat16, device=cuda)
    dp.tile_update(dst, 104, tile)
    torch.cuda.synchronize()
    want = torch.zeros(105)
    want[104] = 2.5
    assert torch.equal(dst.reshape(-1).cpu(), want)


def test_tile_update_offset_past_2_pow_31(cuda):
    """A 64-bit offset: a uint8 template of more than 2^31 elements (or
    the largest that fits), the tile landing past 2^31, both the
    identity copy and an int8 → uint8 cast."""
    from torchsnapshot_tpu_torch.ops import device_pack as dp

    free, _ = torch.cuda.mem_get_info()
    n = min((1 << 31) + (1 << 21), free - (1 << 30))
    if n <= (1 << 31) + (1 << 20):
        pytest.skip(f"the card has {free} bytes free, too few for a template past 2^31 elements")
    dst = torch.zeros(n, dtype=torch.uint8, device=cuda)
    off = (1 << 31) + 12345
    ident = _tile_of(torch.uint8, 300001, cuda, 62)
    dp.tile_update(dst, off, ident)
    cast = _tile_of(torch.int8, 1001, cuda, 63)
    dp.tile_update(dst, off + 400000, cast)
    torch.cuda.synchronize()
    assert torch.equal(dst[off:off + 300001], ident)
    assert torch.equal(dst[off + 400000:off + 401001], cast.to(torch.uint8))
    assert int(dst[:off].count_nonzero()) == 0
    del dst


def test_tile_update_refuses_what_it_cannot_cast(cuda):
    from torchsnapshot_tpu_torch.ops import device_pack as dp

    with pytest.raises(ValueError, match="does not cast"):
        dp.tile_update(torch.zeros(8, device=cuda), 0, torch.ones(4, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="outside"):
        dp.tile_update(torch.zeros(8, device=cuda), 6, torch.ones(4, device=cuda))


@pytest.mark.parametrize("stored,template", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32), (torch.float32, torch.float16),
    (torch.int32, torch.int64), (torch.float32, None),
], ids=lambda d: str(d).replace("torch.", ""))
@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
def test_budgeted_read_into_cuda_template(cuda, tmp_path, stored, template, chunked):
    """read_object with a budget into a CUDA template (or none, onto the
    card): tiles no larger than the budget, K6 launched for a cast and
    not for an identity read, the result equal to the cast of the source,
    pinned tile memory within the budget."""
    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch import knobs
    from torchsnapshot_tpu_torch.ops import device_pack as dp

    src = _tile_of(stored, 3 * (1 << 18) + 77, "cpu", 64).reshape(-1, 1)
    chunk = knobs.override_max_chunk_size_bytes(1 << 20) if chunked else knobs.override_max_chunk_size_bytes(1 << 30)
    with chunk:
        tts.Snapshot.take(str(tmp_path), {"app": tts.StateDict(w=src)})
    budget = 1 << 18
    out = None if template is None else torch.full(src.shape, 7, dtype=template, device=cuda)
    before = dp.LAUNCHES["tile_update"]
    _pinned_gauge().reset_max()
    with knobs.override_verify_on_restore(True):
        got = tts.Snapshot(str(tmp_path)).read_object("0/app/w", obj_out=out, memory_budget_bytes=budget)
    launched = dp.LAUNCHES["tile_update"] - before
    assert got.is_cuda and (template is None or got is out)
    assert torch.equal(got.cpu(), src.to(template or stored))
    assert (launched > 0) == (template not in (None, stored)), launched
    assert 0 < _pinned_gauge().max <= budget


def test_budgeted_read_misses_are_decided_before_any_read(cuda, tmp_path):
    """A cast pair K6 does not take and a non-contiguous CUDA template
    are read whole, counted in ``read.tile_misses``, and come out right."""
    import torchsnapshot_tpu_torch as tts

    src = torch.arange(1 << 16, dtype=torch.float32).reshape(256, 256)
    tts.Snapshot.take(str(tmp_path), {"app": tts.StateDict(w=src)})
    snap = tts.Snapshot(str(tmp_path))
    before = _misses(tts.obs.READ_TILE_MISSES)
    out = torch.zeros((256, 256), dtype=torch.int32, device=cuda)
    snap.read_object("0/app/w", obj_out=out, memory_budget_bytes=1 << 12)
    assert torch.equal(out.cpu(), src.to(torch.int32))
    t = torch.zeros((256, 256), device=cuda).t()
    snap.read_object("0/app/w", obj_out=t, memory_budget_bytes=1 << 12)
    assert torch.equal(t.cpu(), src)
    after = _misses(tts.obs.READ_TILE_MISSES)
    assert after["cast"] == before.get("cast", 0) + 1
    assert after["layout"] == before.get("layout", 0) + 1


def test_budgeted_read_failure_leaves_the_cuda_template_usable(cuda, tmp_path):
    """A corrupted payload under VERIFY_ON_RESTORE raises; the same
    template then takes a retry once the payload is repaired."""
    import pathlib

    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch import knobs

    src = torch.arange(1 << 18, dtype=torch.float32)
    tts.Snapshot.take(str(tmp_path), {"app": tts.StateDict(w=src)})
    target = max((p for p in pathlib.Path(tmp_path).rglob("*") if p.is_file()
                  and "metadata" not in p.name), key=lambda p: p.stat().st_size)
    good = target.read_bytes()
    bad = bytearray(good)
    bad[len(bad) // 2] ^= 0x40
    target.write_bytes(bytes(bad))
    out = torch.zeros(1 << 18, dtype=torch.float64, device=cuda)
    snap = tts.Snapshot(str(tmp_path))
    with knobs.override_verify_on_restore(True):
        with pytest.raises(RuntimeError, match="crc32"):
            snap.read_object("0/app/w", obj_out=out, memory_budget_bytes=1 << 16)
        target.write_bytes(good)
        assert snap.read_object("0/app/w", obj_out=out, memory_budget_bytes=1 << 16) is out
    assert torch.equal(out.cpu(), src.double())


@pytest.fixture
def cuda_mesh(cuda):
    """A 1-rank gloo process group and a ("dp", "tp") CUDA mesh of (1, 1),
    destroyed after the test."""
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    try:
        yield DeviceMesh("cuda", [[0]], mesh_dim_names=("dp", "tp"))
    finally:
        dist.destroy_process_group()


def test_sharded_take_and_restore_on_a_cuda_mesh(cuda_mesh, tmp_path):
    """DTensors on a 1-rank CUDA mesh, boxes subdivided under a small
    MAX_SHARD_SIZE_BYTES (by rows, and by columns for the wide "c"),
    small ones packed by K1: restored bitwise into bf16 DTensors of other
    placements, into f32 DTensors through K6, bitwise equal to K6's plain
    version, and into a plain CUDA tensor; row boxes land in place as
    they are read (one pinned copy, or one K6 launch, per stored box),
    column boxes are assembled in one pinned buffer and land once; no box
    misses the device path, and a budgeted read holds pinned tiles of at
    most the budget."""
    import torchsnapshot_tpu_torch as tts
    from torch.distributed.tensor import Replicate, Shard
    from torchsnapshot_tpu_torch import knobs
    from torchsnapshot_tpu_torch.ops import device_pack as dp
    from torchsnapshot_tpu_torch.parallel.mesh import distribute

    full = {"w": _rand((96, 40), torch.bfloat16, "cuda", 30), "n": _rand((40,), torch.bfloat16, "cuda", 31),
            "m": _rand((33, 7), torch.bfloat16, "cuda", 32), "c": _rand((8, 300), torch.bfloat16, "cuda", 34)}
    layout = {"w": (Replicate(), Shard(1)), "n": (Replicate(), Replicate()), "m": (Shard(0), Replicate()),
              "c": (Replicate(), Replicate())}
    state = tts.StateDict({k: distribute(v, cuda_mesh, layout[k]) for k, v in full.items()})
    k1, k6, misses = dp.LAUNCHES["slab_pack"], dp.LAUNCHES["tile_update"], _misses(tts.obs.READ_TILE_MISSES)
    with knobs.override_max_shard_size_bytes(2048):
        snap = tts.Snapshot.take(str(tmp_path / "s"), {"app": state})
    assert dp.LAUNCHES["slab_pack"] > k1
    assert len(snap.metadata.manifest["0/app/w"].shards) == 4  # 7680 bytes in 2048-byte row boxes
    assert len(snap.metadata.manifest["0/app/c"].shards) == 3  # 4800 bytes in 2048-byte column boxes
    swapped = {"w": (Shard(0), Replicate()), "n": (Replicate(), Replicate()), "m": (Replicate(), Shard(1)),
               "c": (Shard(1), Replicate())}
    bf16 = tts.StateDict({k: distribute(torch.zeros_like(v), cuda_mesh, swapped[k]) for k, v in full.items()})
    f32 = tts.StateDict({k: distribute(torch.zeros(v.shape, device="cuda"), cuda_mesh, layout[k]) for k, v in full.items()})
    plain = tts.StateDict({k: torch.zeros_like(v) for k, v in full.items()})
    for dest in (bf16, f32, plain):
        tts.Snapshot(str(tmp_path / "s")).restore({"app": dest})
    # one launch per stored row box of w, n and m; one for c's assembled box
    assert dp.LAUNCHES["tile_update"] == k6 + 4 + 1 + 1 + 1
    for k, v in full.items():
        assert torch.equal(bf16[k].to_local(), v) and torch.equal(plain[k], v), k
        want = dp.tile_update_plain(torch.zeros(v.numel()), 0, v.cpu().reshape(-1)).reshape(v.shape)
        assert torch.equal(f32[k].to_local().cpu(), want), k
    assert _misses(tts.obs.READ_TILE_MISSES) == misses
    _pinned_gauge().reset_max()
    got = tts.Snapshot(str(tmp_path / "s")).read_object("0/app/w", memory_budget_bytes=1024)
    assert got.device.type == "cuda" and torch.equal(got, full["w"])
    assert 0 < _pinned_gauge().max <= 2 * 1024


def test_sharded_restore_into_a_non_contiguous_local_tensor(cuda_mesh, tmp_path):
    """A DTensor whose local tensor is a transposed view cannot take the
    pinned copy or K6: it counts in ``read.tile_misses.layout`` and is
    copied plainly, still bitwise."""
    import torchsnapshot_tpu_torch as tts
    from torch.distributed.tensor import DTensor, Replicate
    from torchsnapshot_tpu_torch.parallel.mesh import distribute

    src = _rand((48, 64), torch.float32, "cuda", 33)
    tts.Snapshot.take(str(tmp_path / "s"), {"app": tts.StateDict(w=distribute(src, cuda_mesh, (Replicate(), Replicate())))})
    local = torch.zeros(64, 48, device="cuda").t()
    dest = tts.StateDict(w=DTensor.from_local(local, cuda_mesh, [Replicate(), Replicate()], run_check=False))
    before = _misses(tts.obs.READ_TILE_MISSES).get("layout", 0)
    tts.Snapshot(str(tmp_path / "s")).restore({"app": dest})
    assert _misses(tts.obs.READ_TILE_MISSES)["layout"] == before + 1
    assert torch.equal(local, src)


def _payload_files(root):
    import os

    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            # the flight record holds this take's timings, not payload
            if f not in (".snapshot_metadata", ".snapshot_obsrecord"):
                p = os.path.join(dirpath, f)
                out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_fastio_direct_take_and_restore_of_cuda_state(cuda, tmp_path, monkeypatch):
    """CUDA model + AdamW state taken with the engine on O_DIRECT straight
    from the pinned staging buffers (every file direct: DIRECT_MIN_BYTES
    lowered to 1) and with FASTIO=0: byte-identical files and manifest
    digests; the direct snapshot restores bitwise into another model."""
    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch import knobs, obs
    from torchsnapshot_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from torchsnapshot_tpu_torch.storage import fastio

    monkeypatch.setattr(fastio, "DIRECT_MIN_BYTES", 1)

    def state(seed):
        torch.manual_seed(seed)
        model = TransformerLM(TransformerConfig.tiny(), device=cuda)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
        model(torch.randint(0, 256, (2, 16), device=cuda)).float().square().mean().backward()
        opt.step()
        return model, opt

    model, opt = state(0)
    with knobs.override_fastio(False):
        tts.Snapshot.take(str(tmp_path / "py"), {"model": model, "optim": opt})
    before = obs.counters().get(obs.FASTIO_DIRECT_PARTS, 0)
    with knobs.override_fastio_direct(True):
        tts.Snapshot.take(str(tmp_path / "direct"), {"model": model, "optim": opt})
        assert obs.counters().get(obs.FASTIO_DIRECT_PARTS, 0) > before
        fresh, fresh_opt = state(1)
        tts.Snapshot(str(tmp_path / "direct")).restore({"model": fresh, "optim": fresh_opt})
    assert _payload_files(tmp_path / "direct") == _payload_files(tmp_path / "py")
    md = [tts.Snapshot(str(tmp_path / d)).metadata for d in ("py", "direct")]
    assert md[0].objects == md[1].objects
    for (k, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k
    s0, s1 = opt.state_dict()["state"], fresh_opt.state_dict()["state"]
    for i in s0:
        for k in s0[i]:
            assert torch.equal(s0[i][k], s1[i][k]), (i, k)


@pytest.mark.parametrize("template", [torch.bfloat16, torch.float32], ids=["copy", "cast"])
def test_budgeted_read_tiles_filled_by_o_direct(cuda, tmp_path, monkeypatch, template):
    """A budgeted read_object whose pinned tiles are read with O_DIRECT
    gives the same tensor as under FASTIO=0, bitwise."""
    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch import knobs, obs
    from torchsnapshot_tpu_torch.storage import fastio

    monkeypatch.setattr(fastio, "DIRECT_MIN_BYTES", 1)
    src = _tile_of(torch.bfloat16, 3 * (1 << 20) + 77, "cpu", 65)
    tts.Snapshot.take(str(tmp_path), {"app": tts.StateDict(w=src)})
    snap = tts.Snapshot(str(tmp_path))
    outs = {}
    for fio, direct in ((False, False), (True, True)):
        out = torch.zeros(src.shape, dtype=template, device=cuda)
        before = obs.counters()
        with knobs.override_fastio(fio), knobs.override_fastio_direct(direct), \
                knobs.override_verify_on_restore(True):
            assert snap.read_object("0/app/w", obj_out=out, memory_budget_bytes=1 << 20) is out
        direct_parts = obs.counters().get(obs.FASTIO_DIRECT_PARTS, 0) - before.get(obs.FASTIO_DIRECT_PARTS, 0)
        assert (direct_parts >= 6) == direct, direct_parts  # 6+ tiles of at most 1 MiB
        outs[direct] = out
    assert torch.equal(outs[True], outs[False])
    assert torch.equal(outs[True].cpu(), src.to(template))


def test_traced_take_and_restore_of_cuda_state(cuda, tmp_path):
    """A traced take and restore of a small CUDA model (slabs through K1,
    restored through K2): non-zero stage, write, read and consume phase
    counts, a Perfetto JSON that parses, and a flight record whose
    bytes_written is the take's own counter delta."""
    import json

    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch import knobs, obs
    from torchsnapshot_tpu_torch.ops import device_pack as dp

    def state(seed):
        g = torch.Generator(device="cpu").manual_seed(seed)
        return tts.StateDict(**{
            f"w{i}": torch.randn(n, generator=g).to(torch.bfloat16).to(cuda)
            for i, n in enumerate((300, 4097, 1 << 20, 33))
        })

    src, out = state(0), state(1)
    path = str(tmp_path / "snap")
    tracer = obs.get_tracer()
    with knobs.override_trace(1), knobs.override_slab_size_threshold_bytes(1 << 16):
        tracer.reset()
        before = obs.counters().get(obs.BYTES_WRITTEN, 0)
        k1, k2 = dp.LAUNCHES["slab_pack"], dp.LAUNCHES["slab_unpack"]
        tts.Snapshot.take(path, {"m": src})
        written = obs.counters()[obs.BYTES_WRITTEN] - before
        tts.Snapshot(path).restore({"m": out})
        torch.cuda.synchronize()
        n = obs.write_trace(str(tmp_path / "trace.json"))
    tracer.reset()
    assert dp.LAUNCHES["slab_pack"] > k1 and dp.LAUNCHES["slab_unpack"] > k2
    for k in src:
        assert torch.equal(out[k], src[k])
    rec = obs.aggregate.read_obsrecord(path)
    assert rec["merged"]["counters"]["bytes_written"] == written > 0
    take_phases = rec["per_rank"]["0"]["phases"]
    restore_phases = obs.aggregate.last_record("restore")["per_rank"]["0"]["phases"]
    assert take_phases["stage"]["count"] > 0 and take_phases["write"]["count"] > 0
    assert restore_phases["read"]["count"] > 0 and restore_phases["consume"]["count"] > 0
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    names = {e["name"] for e in events if e["ph"] == "X"}
    assert n > 0 and {"take", "restore", "pipeline/slab_pack", "pipeline/consume"} <= names


def _cuda_state(device, bump):
    """Small CUDA tensors that share device slabs (K1) plus a changing one."""
    g = torch.Generator(device="cpu").manual_seed(21)
    frozen = {f"f{i}": torch.randn(257 + i, generator=g).to(torch.bfloat16).to(device) for i in range(6)}
    return {**frozen, "hot": torch.full((300,), float(bump), device=device)}


def test_incremental_take_of_cuda_state_links_unchanged_slabs(cuda, tmp_path):
    """The frozen members' device slab (packed by K1 in both takes, at the
    same location) is hardlinked; the changed tensor is written."""
    import os

    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch import knobs
    from torchsnapshot_tpu_torch.ops import device_pack as dp

    with knobs.override_slab_size_threshold_bytes(3000):
        s1 = tts.Snapshot.take(str(tmp_path / "s1"), {"app": tts.StateDict(_cuda_state(cuda, 0))})
        tts.obs.reset_metrics()
        before = dp.LAUNCHES["slab_pack"]
        s2 = tts.Snapshot.async_take(
            str(tmp_path / "s2"), {"app": tts.StateDict(_cuda_state(cuda, 1))}, base=str(tmp_path / "s1")
        ).wait()
    assert dp.LAUNCHES["slab_pack"] > before
    m1, m2 = s1.get_manifest(), s2.get_manifest()
    slab = m2["0/app/f0"].location
    assert "batched" in slab and slab == m1["0/app/f0"].location
    assert os.stat(tmp_path / "s2" / slab).st_ino == os.stat(tmp_path / "s1" / slab).st_ino
    hot = m2["0/app/hot"].location
    assert os.stat(tmp_path / "s2" / hot).st_ino != os.stat(tmp_path / "s1" / hot).st_ino
    assert tts.obs.counters()[tts.obs.BYTES_DEDUPED] >= os.path.getsize(tmp_path / "s2" / slab)
    assert s2.verify(deep=True).ok


def test_priority_restore_into_cuda_templates_is_bitwise(cuda, tmp_path):
    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch import knobs
    from torchsnapshot_tpu_torch.ops import device_pack as dp

    want = _cuda_state(cuda, 3)
    with knobs.override_slab_size_threshold_bytes(3000):
        tts.Snapshot.take(str(tmp_path / "s"), {"app": tts.StateDict(want)})
    dest = tts.StateDict({k: torch.zeros_like(v) for k, v in want.items()})
    before = dp.LAUNCHES["slab_unpack"]
    tts.Snapshot(str(tmp_path / "s")).restore({"app": dest}, priority=["app/hot", "app/f3"])
    assert dp.LAUNCHES["slab_unpack"] > before
    for k, v in want.items():
        assert dest[k].is_cuda and torch.equal(dest[k], v), k
    got = tts.Snapshot(str(tmp_path / "s")).materialize()["app"]
    for k, v in want.items():
        assert got[k].is_cuda and torch.equal(got[k], v), k


def _stripe_knobs(codec):
    import contextlib

    from torchsnapshot_tpu_torch import knobs

    stack = contextlib.ExitStack()
    stack.enter_context(knobs.override_stripe_part_size_bytes(64 << 10))
    stack.enter_context(knobs.override_stripe_min_object_size_bytes(128 << 10))
    stack.enter_context(knobs.override_codec(codec))
    stack.enter_context(knobs.override_slab_size_threshold_bytes(3000))
    return stack


@pytest.mark.parametrize("codec", ["raw", "zlib", "huff"])
def test_striped_and_encoded_take_and_restore_of_cuda_state(cuda, tmp_path, codec):
    """CUDA tensors over the stripe threshold stage whole (one D2H copy)
    and take the whole-staged striped write; a slab packed by K1 is
    encoded like any object; the restore decodes the frames and K2
    unpacks them, bitwise."""
    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch.ops import device_pack as dp

    want = dict(_cuda_state(cuda, 4))
    want["big"] = _rand((300, 257), torch.float32, cuda, 11)  # 308 KB: 5 parts
    tts.obs.reset_metrics()
    with _stripe_knobs(codec):
        tts.Snapshot.take(str(tmp_path / "s"), {"app": tts.StateDict(want)})
        counts = tts.obs.counters()
        assert counts.get("storage.stripe.writes", 0) >= 1
        assert counts.get("storage.stripe.streamed_writes", 0) == 0  # device stagers stage whole
        if codec != "raw":
            assert counts.get("storage.codec.parts_encoded", 0) > 0
            assert tts.Snapshot(str(tmp_path / "s")).metadata.codecs
        dest = tts.StateDict({k: torch.zeros_like(v) for k, v in want.items()})
        before = dp.LAUNCHES["slab_unpack"]
        tts.Snapshot(str(tmp_path / "s")).restore({"app": dest})
        assert dp.LAUNCHES["slab_unpack"] > before
    for k, v in want.items():
        assert dest[k].is_cuda and torch.equal(dest[k], v), k
    assert tts.verify_snapshot(str(tmp_path / "s"), deep=True).ok


def test_part_streamed_async_take_of_offloaded_cuda_state(cuda, tmp_path, monkeypatch):
    """With no device-copy budget, ``async_take`` copies each CUDA tensor
    to pinned host memory before it returns; such offloaded leaves then
    part-stream (and encode per part), and restore bitwise; a budgeted
    read of the encoded tensor into an f32 template lands through K6."""
    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch import host_offload
    from torchsnapshot_tpu_torch.ops import device_pack as dp

    monkeypatch.setattr(host_offload, "device_copy_budget_bytes", lambda device: 0)
    want = {"big": _rand((300, 257), torch.bfloat16, cuda, 12), "b2": _rand((600, 257), torch.bfloat16, cuda, 13)}
    tts.obs.reset_metrics()
    with _stripe_knobs("huff"):
        tts.Snapshot.async_take(str(tmp_path / "s"), {"app": tts.StateDict(want)}).wait()
        assert tts.obs.counters().get("storage.stripe.streamed_writes", 0) == 2
        dest = tts.StateDict({k: torch.zeros_like(v) for k, v in want.items()})
        tts.Snapshot(str(tmp_path / "s")).restore({"app": dest})
        tmpl = torch.zeros(600, 257, device=cuda)
        before = dp.LAUNCHES["tile_update"]
        tts.Snapshot(str(tmp_path / "s")).read_object("0/app/b2", obj_out=tmpl, memory_budget_bytes=50000)
        assert dp.LAUNCHES["tile_update"] > before
    for k, v in want.items():
        assert torch.equal(dest[k], v), k
    assert torch.equal(tmpl, want["b2"].float())


@pytest.mark.parametrize("mode", ["take", "async_take"])
def test_cas_take_and_restore_of_cuda_state(cuda, tmp_path, monkeypatch, mode):
    """A content-addressed take of CUDA state: K1 packs the slab and the
    chunks are cut from the staged bytes; with no device-copy budget
    ``async_take``'s offloaded large leaf streams chunk by chunk.  A second
    take of the same state writes nothing new.  The restore assembles
    the chunks and K2 unpacks the slab, bitwise; a budgeted read of the
    large leaf into an f32 template lands through K6 in tiles that
    straddle chunks."""
    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch import host_offload, knobs
    from torchsnapshot_tpu_torch.ops import device_pack as dp

    if mode == "async_take":
        monkeypatch.setattr(host_offload, "device_copy_budget_bytes", lambda device: 0)
    want = dict(_cuda_state(cuda, 5))
    want["big"] = _rand((300, 257), torch.bfloat16, cuda, 14)  # 154 KB
    tts.obs.reset_metrics()
    with _stripe_knobs("raw") as stack:
        stack.enter_context(knobs.override_cas_chunk_size_bytes(32 << 10))
        before = dp.LAUNCHES["slab_pack"]
        for step in (0, 1):
            path = str(tmp_path / f"s{step}")
            if mode == "take":
                tts.Snapshot.take(path, {"app": tts.StateDict(want)}, cas=True)
            else:
                tts.Snapshot.async_take(path, {"app": tts.StateDict(want)}, cas=True).wait()
            counts = tts.obs.counters()
            if step == 0:
                written = counts["cas.bytes_written"]
                assert dp.LAUNCHES["slab_pack"] > before and written > 0
        assert counts["cas.bytes_written"] == written  # the second take moved nothing
        dest = tts.StateDict({k: torch.zeros_like(v) for k, v in want.items()})
        before = dp.LAUNCHES["slab_unpack"]
        tts.Snapshot(str(tmp_path / "s1")).restore({"app": dest})
        assert dp.LAUNCHES["slab_unpack"] > before
        tmpl = torch.zeros(300, 257, device=cuda)
        before = dp.LAUNCHES["tile_update"]
        tts.Snapshot(str(tmp_path / "s1")).read_object("0/app/big", obj_out=tmpl, memory_budget_bytes=50000)
        assert dp.LAUNCHES["tile_update"] > before
    for k, v in want.items():
        assert dest[k].is_cuda and torch.equal(dest[k], v), k
    assert torch.equal(tmpl, want["big"].float())
    assert tts.verify_snapshot(str(tmp_path / "s1"), deep=True).ok


def test_mapped_slab_reaches_k2_with_no_host_copy(cuda, tmp_path, monkeypatch):
    """Under MMAP (the default) the slab's read is a private map, and the
    host-to-device copy K2 consumes is made straight from its pages: the
    tensor handed to the copy lies inside the mapping, and no bytearray
    is made on the way."""
    import builtins

    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch.io_types import is_mmap_backed
    from torchsnapshot_tpu_torch.ops import device_pack as dp

    want = dict(_cuda_state(cuda, 6))
    path = str(tmp_path / "s")
    with _stripe_knobs("raw"):
        tts.Snapshot.take(path, {"app": tts.StateDict(want)})
    sources = []
    real_from = torch.frombuffer

    def spy_from(buf, *a, **kw):
        t = real_from(buf, *a, **kw)
        sources.append(is_mmap_backed(t))
        return t

    made = []
    real_bytearray = builtins.bytearray
    monkeypatch.setattr(dp.torch, "frombuffer", spy_from)
    monkeypatch.setattr(dp, "bytearray", lambda *a: made.append(1) or real_bytearray(*a), raising=False)
    dest = tts.StateDict({k: torch.zeros_like(v) for k, v in want.items()})
    before = (dp.LAUNCHES["slab_unpack"], tts.obs.counters().get("storage.mmap.reads", 0))
    with _stripe_knobs("raw"):
        tts.Snapshot(path).restore({"app": dest})
    assert dp.LAUNCHES["slab_unpack"] > before[0]
    assert tts.obs.counters()["storage.mmap.reads"] > before[1]
    assert sources and all(sources) and not made
    for k, v in want.items():
        assert torch.equal(dest[k], v), k


@pytest.mark.parametrize("policy", ["write_through", "write_back"])
def test_tiered_take_and_restore_of_cuda_state(cuda, tmp_path, policy):
    """A tiered take of CUDA state (K1 packs the slab into the fast tier;
    under write-back the promoter copies it to the durable tier with host
    buffers only), restored fast-first and, after the fast copy is
    wiped, from the durable tier through the host cache (K2 both times),
    and a budgeted read of the large leaf through the tier into an f32
    template (K6), bitwise."""
    import shutil

    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch import knobs
    from torchsnapshot_tpu_torch.ops import device_pack as dp

    want = dict(_cuda_state(cuda, 7))
    want["big"] = _rand((300, 257), torch.bfloat16, cuda, 15)
    fast, dur = str(tmp_path / "fast"), str(tmp_path / "dur")
    opts = {"tier": {"fast_url": fast, "policy": policy}}
    with _stripe_knobs("raw") as stack:
        before = dp.LAUNCHES["slab_pack"]
        tts.Snapshot.take(dur, {"app": tts.StateDict(want)}, storage_options=opts)
        assert dp.LAUNCHES["slab_pack"] > before
        tts.drain_promotions(timeout_s=120)
        stack.enter_context(knobs.override_cache_dir(str(tmp_path / "cache")))
        for label in ("fast", "durable"):
            if label == "durable":
                shutil.rmtree(fast)
            dest = tts.StateDict({k: torch.zeros_like(v) for k, v in want.items()})
            before = dp.LAUNCHES["slab_unpack"]
            tts.Snapshot(dur, storage_options=opts).restore({"app": dest})
            assert dp.LAUNCHES["slab_unpack"] > before, label
            for k, v in want.items():
                assert dest[k].is_cuda and torch.equal(dest[k], v), (label, k)
        tmpl = torch.zeros(300, 257, device=cuda)
        before = dp.LAUNCHES["tile_update"]
        tts.Snapshot(dur, storage_options=opts).read_object("0/app/big", obj_out=tmpl, memory_budget_bytes=50000)
        assert dp.LAUNCHES["tile_update"] > before
    assert torch.equal(tmpl, want["big"].float())
    assert tts.obs.counters()[tts.obs.CACHE_MISSES] > 0


@pytest.mark.parametrize("scheme", ["s3", "gs"])
def test_cloud_take_and_restore_of_cuda_state(cuda, scheme):
    """A take of CUDA state to ``s3://`` / ``gs://`` over the in-process
    fakes of ``tests/cloud_fakes.py`` (K1), a restore into zeroed CUDA
    templates (K2) and a budgeted read into an f32 template (K6) whose
    ranged GETs stay within the budget, bitwise; S3 leaves no multipart
    upload in progress, GCS no part blob."""
    import cloud_fakes

    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch import knobs
    from torchsnapshot_tpu_torch.ops import device_pack as dp

    fake = cloud_fakes.S3Fake() if scheme == "s3" else cloud_fakes.GCSFake()
    undo = (cloud_fakes.install_s3 if scheme == "s3" else cloud_fakes.install_gcs)(fake)
    url = f"{scheme}://bkt/run/s0"
    opts = {} if scheme == "s3" else {"chunk_bytes": 1 << 20}
    want = dict(_cuda_state(cuda, 3))
    want["big"] = _rand((3000, 1000), torch.bfloat16, cuda, 16)  # 6 MB: striped (and composed)
    try:
        with knobs.override_stripe_part_size_bytes(5 << 20), knobs.override_stripe_min_object_size_bytes(5 << 20):
            before = dp.LAUNCHES["slab_pack"]
            tts.Snapshot.take(url, {"app": tts.StateDict(want)}, storage_options=opts)
            assert dp.LAUNCHES["slab_pack"] > before
            dest = tts.StateDict({k: torch.zeros_like(v) for k, v in want.items()})
            before = dp.LAUNCHES["slab_unpack"]
            tts.Snapshot(url, storage_options=opts).restore({"app": dest})
            assert dp.LAUNCHES["slab_unpack"] > before
        for k, v in want.items():
            assert dest[k].is_cuda and torch.equal(dest[k], v), k
        tmpl = torch.zeros(3000, 1000, device=cuda)
        fake.ranges.clear()
        before = dp.LAUNCHES["tile_update"]
        tts.Snapshot(url, storage_options=opts).read_object("0/app/big", obj_out=tmpl, memory_budget_bytes=1 << 20)
        assert dp.LAUNCHES["tile_update"] > before and torch.equal(tmpl, want["big"].float())
        assert fake.ranges and max(n for _, n in fake.ranges) <= 1 << 20
        if scheme == "s3":
            assert fake.ops["complete_multipart_upload"] == 1 and fake.multipart_uploads == {}
        else:
            assert fake.ops["compose"] >= 1 and not any(".part-" in n for n in fake.bucket("bkt").data)
    finally:
        undo()


def test_original_format_from_and_onto_the_card(cuda, tmp_path):
    """``write_torchsnapshot`` of CUDA tensors lays down the bytes it lays
    down for their host copies; ``read_torchsnapshot``, the CLI's
    ``convert`` and the optimizer adapter hold tensors on the card by
    default."""
    import os

    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch.__main__ import main as cli
    from torchsnapshot_tpu_torch.tricks import TorchOptimizerAdapter, read_torchsnapshot, write_torchsnapshot

    torch.manual_seed(4)
    model = torch.nn.Linear(64, 32).to(cuda).to(torch.bfloat16)
    opt = torch.optim.AdamW(model.parameters(), lr=0.1)
    model(torch.randn(8, 64, device=cuda, dtype=torch.bfloat16)).float().sum().backward()
    opt.step()
    state = {"model": model.state_dict(), "optim": {"state": opt.state_dict()["state"]}, "n": 3}
    host = {"model": {k: v.cpu() for k, v in model.state_dict().items()},
            "optim": {"state": {i: {k: v.cpu() for k, v in st.items()} for i, st in opt.state_dict()["state"].items()}},
            "n": 3}
    write_torchsnapshot(str(tmp_path / "card"), state)
    write_torchsnapshot(str(tmp_path / "host"), host)
    for f in os.listdir(tmp_path / "host"):
        if os.path.isfile(tmp_path / "host" / f):
            assert open(tmp_path / "card" / f, "rb").read() == open(tmp_path / "host" / f, "rb").read()
    got = read_torchsnapshot(str(tmp_path / "card"))
    for k, v in model.state_dict().items():
        assert got["model"][k].is_cuda and torch.equal(got["model"][k], v), k
    assert cli(["convert", str(tmp_path / "card"), str(tmp_path / "native")]) == 0
    assert torch.equal(tts.Snapshot(str(tmp_path / "native")).read_object("0/model/weight"), model.weight)
    opt2 = torch.optim.AdamW(model.parameters(), lr=0.1)
    TorchOptimizerAdapter(opt2).load_state_dict(
        {"state": {i: {k: v.cpu() for k, v in st.items()} for i, st in opt.state_dict()["state"].items()},
         "param_groups": opt.state_dict()["param_groups"]})
    st = opt2.state_dict()["state"][0]
    assert st["exp_avg"].is_cuda and st["step"].device.type == "cpu"
    opt2.step()


def test_collective_transport_local_round_trip_on_cuda(cuda):
    """The collective engine's local mode keeps its parts on the card
    (host → device → host) and hands back the exact bytes."""
    from torchsnapshot_tpu_torch import knobs
    from torchsnapshot_tpu_torch.coordination import LocalCoordinator
    from torchsnapshot_tpu_torch.transport import resolve_transport
    from torchsnapshot_tpu_torch.transport import collective as collective_mod

    data = np.random.default_rng(0).integers(0, 256, 3 * 4096 + 17, dtype=np.uint8).tobytes()
    with knobs.override_transport("collective"), knobs.override_transport_part_bytes(4096):
        t = resolve_transport(LocalCoordinator(), device=cuda)
        assert t.engine == "collective" and t.mode == "local"
        try:
            assert t.publish("x/a", data) == 4
            parts = collective_mod._REGISTRY["x/a"][0]
            assert all(p.is_cuda for p in parts)
            assert t.try_fetch("x/a") == data
        finally:
            t.close()


def test_continuous_decode_leaf_onto_cuda(cuda):
    """A mirror's bf16 and f32 leaves come back on the card, bitwise."""
    from torchsnapshot_tpu_torch.continuous.store import decode_leaf, encode_leaf

    for leaf in (_rand((33, 7), torch.bfloat16, "cpu", 20), _rand((5,), torch.float32, "cpu", 21)):
        rec, view = encode_leaf(leaf)
        back = decode_leaf(rec, bytes(view), device=cuda)
        assert back.is_cuda and back.dtype == leaf.dtype and torch.equal(back.cpu(), leaf)


def test_device_move_on_the_card_round_trips_on_a_side_stream(cuda):
    """The collective engine's ``device_move`` in local mode: parts onto
    the card and back on the engine's own stream (not the default one),
    bitwise, one move counted."""
    from torchsnapshot_tpu_torch import knobs, obs
    from torchsnapshot_tpu_torch.coordination import LocalCoordinator
    from torchsnapshot_tpu_torch.transport import resolve_transport

    data = np.random.default_rng(1).integers(0, 256, 5 * 4096 + 3, dtype=np.uint8).tobytes()
    with knobs.override_transport("collective"), knobs.override_transport_part_bytes(4096):
        t = resolve_transport(LocalCoordinator(), device=cuda)
        assert t.engine == "collective" and t.mode == "local"
        moves0 = obs.counter(obs.TRANSPORT_DEVICE_MOVES).value
        try:
            assert bytes(t.device_move(data)) == data
        finally:
            t.close()
    assert obs.counter(obs.TRANSPORT_DEVICE_MOVES).value == moves0 + 1
    assert t._stream is not None and t._stream != torch.cuda.default_stream(cuda)


def test_continuous_loop_over_cuda_state_recovered_bitwise_on_cuda(cuda, tmp_path):
    """A small model and AdamW on the card under ``ContinuousCheckpointer``
    with the collective transport: the peer's chunks take the device round
    trip (one move per chunk replicated), the state is mutated right after
    ``step()``, and ``restore_latest`` brings the step back onto the card
    bitwise, the optimizer's ``step`` staying on the CPU."""
    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch import knobs, obs
    from torchsnapshot_tpu_torch.resilience import preemption

    def build(seed):
        torch.manual_seed(seed)
        model = torch.nn.Sequential(torch.nn.Linear(64, 256), torch.nn.Linear(256, 64)).to(cuda)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
        model(torch.randn(4, 64, device=cuda)).square().mean().backward()
        opt.step()
        return model, opt

    model, opt = build(0)
    counters = ("transport.device_moves", "continuous.chunks_replicated", "transport.fallbacks")
    before = {n: obs.counter(n).value for n in counters}
    with knobs.override_transport("collective"):
        cc = tts.ContinuousCheckpointer(str(tmp_path / "local"), replica_roots=[str(tmp_path / "peer")],
                                        chunk_size_bytes=16384, preemption_hook=False)
        try:
            for step in (1, 2):
                model(torch.randn(4, 64, device=cuda)).square().mean().backward()
                opt.step()
                assert cc.step({"model": model, "optim": opt}, step)
                want = ({k: v.clone() for k, v in model.state_dict().items()},
                        {i: {k: v.clone() for k, v in st.items()} for i, st in opt.state_dict()["state"].items()})
                with torch.no_grad():
                    for p in model.parameters():
                        p.add_(1.0)  # right after step(), mid-replication
            cc.drain()
        finally:
            cc.close()
            preemption.uninstall()
    delta = {n: obs.counter(n).value - before[n] for n in counters}
    assert delta["transport.device_moves"] == delta["continuous.chunks_replicated"] > 0
    assert delta["transport.fallbacks"] == 0
    model2, opt2 = build(1)
    cc2 = tts.ContinuousCheckpointer(str(tmp_path / "local"), replica_roots=[str(tmp_path / "peer")],
                                     preemption_hook=False)
    try:
        res = cc2.restore_latest({"model": model2, "optim": opt2})
    finally:
        cc2.close()
    assert res["step"] == 2 and res["source"] == "local"
    for k, v in model2.state_dict().items():
        assert v.is_cuda and torch.equal(v, want[0][k]), k
    for i, st in opt2.state_dict()["state"].items():
        assert st["step"].device.type == "cpu" and st["exp_avg"].is_cuda
        for k, v in st.items():
            assert torch.equal(v, want[1][i][k]), (i, k)


def test_subscriber_on_the_card_swaps_bitwise_under_pinned_readers(cuda, tmp_path):
    """A subscriber holding a bf16 ``nn.Module`` on the card follows four
    published steps (each fills every parameter with the step) while two
    reader threads, each on its own stream, run matmuls on the parameters
    under ``pinned()``: every read sees one generation, the parameters
    stay the same objects on the card, and each delta's basis is a counted
    device-to-host copy."""
    import threading

    from torchsnapshot_tpu_torch.publish import Publisher, Subscriber

    model = torch.nn.Sequential(torch.nn.Linear(512, 512), torch.nn.Linear(512, 512))
    model = model.to(device=cuda, dtype=torch.bfloat16)
    params = list(model.parameters())
    src = torch.nn.Sequential(torch.nn.Linear(512, 512), torch.nn.Linear(512, 512)).to(torch.bfloat16)
    root = str(tmp_path / "pub")
    pub = Publisher(root, chunk_size_bytes=64 * 1024)
    sub = Subscriber(root, {"m": model})
    stop = threading.Event()
    torn, reads = [], [0]

    def reader():
        stream = torch.cuda.Stream(device=cuda)
        x = torch.ones(64, 512, device=cuda, dtype=torch.bfloat16)
        while not stop.is_set():
            with torch.cuda.stream(stream), sub.live.pinned() as (step, _gen):
                y = model(x)
                first = float(params[0].detach().reshape(-1)[0])
                last = float(params[-1].detach().reshape(-1)[-1])
                stream.synchronize()
                if step is not None and not (first == last == float(step)):
                    torn.append((step, first, last))
                reads[0] += int(torch.isfinite(y).all())

    threads = [threading.Thread(target=reader) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        for step in (1, 2, 3, 4):
            with torch.no_grad():
                for p in src.parameters():
                    p.fill_(float(step))
            pub.publish_state({"m": src}, step)
            assert sub.poll_once() == step
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        sub.close()
        pub.close()
    assert torn == [] and reads[0] > 0
    assert [p is q for p, q in zip(model.parameters(), params)] == [True] * len(params)
    for p, q in zip(model.parameters(), src.parameters()):
        assert p.is_cuda and p.dtype == torch.bfloat16 and torch.equal(p.cpu(), q)
    assert sub.live.basis_copies == 3 * len(params) and sub.live.basis_bytes > 0


def _pinned_state(device):
    """Leaves of each read path under ``_pinned_knobs``: a striped whole
    object, a whole one below the stripe threshold, a chunked one (a
    striped chunk and a whole one), a whole one, a chunked one and a slab
    member restored into f32 templates (cast on the card), and small
    members sharing a device slab; with each leaf's template dtype."""
    g = torch.Generator(device="cpu").manual_seed(31)
    leaves = {
        "striped": torch.randn(512, 300, generator=g).to(torch.bfloat16),
        "whole": torch.randn(20000, generator=g),
        "cast": torch.randn(300, 200, generator=g).to(torch.bfloat16),
        "chunked": torch.randn(300, 400, generator=g),
        "chunked_cast": torch.randn(300, 800, generator=g).to(torch.bfloat16),
        # sorts into the first slab; s5 is left a slab of its own (one
        # ranged read, not merged)
        "s0cast": torch.randn(333, generator=g).to(torch.bfloat16),
        **{f"s{i}": torch.randn(257 + i, generator=g).to(torch.bfloat16) for i in range(6)},
    }
    templates = {k: torch.float32 if "cast" in k else v.dtype for k, v in leaves.items()}
    return {k: v.to(device) for k, v in leaves.items()}, templates


def _pinned_knobs():
    """``_stripe_knobs`` with arrays above 400,000 bytes chunked."""
    from torchsnapshot_tpu_torch import knobs

    stack = _stripe_knobs("raw")
    stack.enter_context(knobs.override_max_chunk_size_bytes(400_000))
    return stack


def _restore_pinned(url, templates, shapes, device, after=None):
    import torchsnapshot_tpu_torch as tts

    dest = tts.StateDict({k: torch.zeros(shapes[k], dtype=d, device=device) for k, d in templates.items()})
    dest["step"] = 0
    if after is not None:
        after(dest)
    tts.Snapshot(url).restore({"app": dest})
    torch.cuda.synchronize()
    return dest


@pytest.mark.parametrize("budget", [None, 100_000], ids=["default_budget", "budget_below_state"])
def test_restore_into_cuda_templates_lands_through_pinned_read_buffers(cuda, monkeypatch, budget):
    """Striped leaves, whole leaves, chunked leaves, device slabs and bf16
    → f32 cast templates restore bitwise equal to a plain host restore,
    every byte copied to the card from a pinned read buffer
    (``read.pinned_bytes`` is the CUDA templates' stored bytes, all the
    bytes read), and the pinned high-water mark within the budget plus
    one leaf."""
    import uuid

    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch.ops import device_pack as dp
    from torchsnapshot_tpu_torch.storage.memory import reset_namespace

    if budget is not None:
        monkeypatch.setenv("TORCHSNAPSHOT_TPU_TORCH_PER_RANK_MEMORY_BUDGET_BYTES", str(budget))
    leaves, templates = _pinned_state(cuda)
    shapes = {k: v.shape for k, v in leaves.items()}
    sizes = {k: v.numel() * v.element_size() for k, v in leaves.items()}
    url = f"memory://pinned-{uuid.uuid4().hex}"
    try:
        with _pinned_knobs():
            tts.Snapshot.take(url, {"app": tts.StateDict({**leaves, "step": 5})})
            host = _restore_pinned(url, templates, shapes, "cpu")
            c0 = dict(tts.obs.counters())
            k2 = dp.LAUNCHES["slab_unpack"]
            _pinned_gauge().reset_max()
            got = _restore_pinned(url, templates, shapes, cuda)
            hw = _pinned_gauge().max
        c1 = tts.obs.counters()
    finally:
        reset_namespace(url.split("://")[1])
    assert got["step"] == 5 and dp.LAUNCHES["slab_unpack"] > k2
    for k in leaves:
        assert got[k].is_cuda and got[k].dtype == templates[k], k
        assert torch.equal(got[k].cpu(), host[k]), k
    pinned = c1[tts.obs.READ_PINNED_BYTES] - c0.get(tts.obs.READ_PINNED_BYTES, 0)
    read = c1[tts.obs.BYTES_READ] - c0.get(tts.obs.BYTES_READ, 0)
    assert pinned == read == sum(sizes.values())
    assert 0 < hw <= (budget or sum(sizes.values())) + max(sizes.values())


@pytest.mark.parametrize("side", [False, True], ids=["current_stream", "side_stream"])
def test_pinned_restore_lands_after_work_queued_on_the_template(cuda, side):
    """A restore planned right behind slow work queued on the templates
    (a sleep, then a fill) lands after it: whole, chunk and slab copies go
    on the stream current when the restore was called."""
    import uuid

    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch.storage.memory import reset_namespace

    leaves, templates = _pinned_state(cuda)
    url = f"memory://pinned-order-{uuid.uuid4().hex}"

    def queue_fill(dest):
        torch.cuda._sleep(200_000_000)
        for k in leaves:
            dest[k].fill_(7)

    stream = torch.cuda.Stream() if side else torch.cuda.current_stream()
    try:
        with _pinned_knobs():
            tts.Snapshot.take(url, {"app": tts.StateDict({**leaves, "step": 5})})
            with torch.cuda.stream(stream):
                got = _restore_pinned(url, templates, {k: v.shape for k, v in leaves.items()}, cuda, queue_fill)
    finally:
        reset_namespace(url.split("://")[1])
    for k, v in leaves.items():
        assert torch.equal(got[k], v.to(templates[k])), k


def test_a_failed_landing_gives_its_pinned_buffer_back(cuda, monkeypatch):
    """A landing whose copy raises gives its pinned read buffer back: the
    restore fails and ``read.pinned_in_use_bytes`` reads what it read
    before.  A buffer the storage owns (a plugin that leaves the offered
    buffer unfilled) lands bitwise by a plain copy, without adding to
    ``read.pinned_bytes``."""
    import uuid

    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch.ops import transfer
    from torchsnapshot_tpu_torch.storage.memory import MemoryStoragePlugin, reset_namespace

    src = _rand((512, 256), torch.float32, cuda, 40)
    url = f"memory://pinned-lease-{uuid.uuid4().hex}"
    real_copy, real_read = transfer.to_device, MemoryStoragePlugin.read

    def failing_copy(*args, **kwargs):
        raise RuntimeError("injected landing failure")

    async def ignore_offer(self, read_io):
        read_io.into = None
        await real_read(self, read_io)

    try:
        tts.Snapshot.take(url, {"app": tts.StateDict(w=src)})
        in_use = _pinned_gauge().value
        dest = tts.StateDict(w=torch.zeros_like(src))
        monkeypatch.setattr(transfer, "to_device", failing_copy)
        with pytest.raises(RuntimeError, match="injected landing failure"):
            tts.Snapshot(url).restore({"app": dest})
        assert _pinned_gauge().value == in_use
        monkeypatch.setattr(transfer, "to_device", real_copy)
        monkeypatch.setattr(MemoryStoragePlugin, "read", ignore_offer)
        pinned = tts.obs.counters().get(tts.obs.READ_PINNED_BYTES, 0)
        tts.Snapshot(url).restore({"app": dest})
        torch.cuda.synchronize()
    finally:
        reset_namespace(url.split("://")[1])
    assert torch.equal(dest["w"], src)
    assert tts.obs.counters().get(tts.obs.READ_PINNED_BYTES, 0) == pinned
    assert _pinned_gauge().value == in_use


@pytest.mark.parametrize("budget", ["device_copies", "no_device_budget"])
def test_async_take_into_memory_adopts_the_pinned_staging_buffers(cuda, monkeypatch, budget):
    """An async take of CUDA leaves (a slab K1 packs, a leaf over the
    stripe threshold, one below it) into ``memory://`` keeps each pinned
    staging buffer as the stored object: every data object lies in pinned
    memory, the adopted bytes are the staged bytes, nothing is striped
    or streamed, and the snapshot restores bitwise and deep-verifies
    although every leaf changed right after the return.  With no
    device-copy budget the leaves reach pinned memory before the return
    and are adopted whole all the same."""
    import uuid
    import warnings

    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch import host_offload
    from torchsnapshot_tpu_torch.ops import device_pack as dp
    from torchsnapshot_tpu_torch.storage import memory

    if budget == "no_device_budget":
        monkeypatch.setattr(host_offload, "device_copy_budget_bytes", lambda device: 0)
    ns = f"adopt-{uuid.uuid4().hex}"
    url = f"memory://{ns}"
    want = dict(_cuda_state(cuda, 2))
    want["big"] = _rand((300, 257), torch.float32, cuda, 14)  # 308 KB: 5 parts
    want["mid"] = _rand((100, 50), torch.bfloat16, cuda, 15)
    live = {k: v.clone() for k, v in want.items()}
    tts.obs.reset_metrics()
    try:
        with _stripe_knobs("raw"):
            before = dp.LAUNCHES["slab_pack"]
            pending = tts.Snapshot.async_take(url, {"app": tts.StateDict(live)})
            for v in live.values():
                v.add_(1)  # the next step, on the same stream
            pending.wait()
            assert dp.LAUNCHES["slab_pack"] > before
            counts = tts.obs.counters()
            staged = counts[tts.obs.BYTES_STAGED]
            assert staged >= sum(v.numel() * v.element_size() for v in want.values())
            assert counts[tts.obs.MEMORY_ADOPTED_BYTES] == staged == counts[tts.obs.BYTES_WRITTEN]
            assert counts.get(tts.obs.STRIPE_WRITES, 0) == 0
            assert host_offload.LAST_OFFLOAD_STATS["blocking_host_bytes"] == (
                staged if budget == "no_device_budget" else 0
            )
            data = {p: b for p, b in memory._NAMESPACES[ns].items() if not p.startswith(".snapshot")}
            assert sum(b.nbytes for b in data.values()) == staged
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # torch.from_numpy of a read-only array
                for path, buf in data.items():
                    assert not buf.flags.writeable, path
                    assert torch.from_numpy(buf).is_pinned(), path
            dest = tts.StateDict({k: torch.zeros_like(v) for k, v in want.items()})
            tts.Snapshot(url).restore({"app": dest})
        for k, v in want.items():
            assert torch.equal(dest[k], v), k
        assert tts.verify_snapshot(url, deep=True).ok
    finally:
        memory.reset_namespace(ns)
