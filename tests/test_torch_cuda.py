"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips, with the reason, where
``torch.cuda.is_available()`` is false.  On a machine with the card:
``python -m pytest tests/test_torch_cuda.py -q``.  Tolerances: K1 and K2
bitwise; K3 m atol 1e-3 and pv/l compared after normalisation within
2e-2 for bf16 inputs (bf16 operands, another summation order), 1e-4 for
f32 ones.
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
    """d = 100 takes the kernel's synchronous (non-16-byte) load path."""
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
