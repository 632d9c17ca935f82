"""Flash-attention partials for the ring-attention step: the forward
(K3) and its backward (K4 dq, K5 dk/dv) under autograd.

Counterpart of ``torchsnapshot_tpu/ops/flash_attention.py``: the Pallas
``_attend_kernel``, ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` become the
hand-written CUDA kernels in ``csrc/flash_attention_{fwd,bwd_dq,bwd_dkv}.cu``.
The contract is the JAX one:

- ``attend_partials`` (``_flash_partials_jit``): q [bh, sq, d], k/v
  [bh, sk, d] → f32 (pv [bh, sq, d], raw row max m [bh, sq], row
  sum-exp l [bh, sq]), causal mask on global positions, rows ≥ sq_real
  and columns ≥ sk_real masked;
- ``flash_bwd`` (``_flash_bwd_jit``): the cotangents of (pv, m, l) →
  f32 (dq, dk, dv) without the g_m term, and the i32 row argmax ``amax``
  (first column at the recomputed row max, −1 for a row that sees none);
- ``flash_attention_partials`` ([b, s, h, d] layout, with
  ``_partials_impl``'s post-processing: pv cast to v's dtype, m_safe,
  valid = l > 0) and the normalised ``flash_attention``, both
  differentiable through ``_DiffPartials`` (the ``custom_vjp`` of
  ``_make_diff_partials``): its backward is ``_flash_bwd``, which applies
  the g_m term on ``amax`` outside the kernels.  CPU and CUDA tensors
  share that one gradient contract; the g_m cotangent lands on the first
  argmax column, never split over ties.

Every wrapper takes its plain version only for CPU tensors; for CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import kernels

LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
# bf16 ``attend_partials`` and ``flash_bwd`` calls whose operands TMA could
# not read as they were (head dim not a multiple of 8, or a base not
# 16-byte aligned): the same kernels on zero-padded copies
PADDED = {"flash_fwd": 0, "flash_bwd": 0}
_COUNT_LOCK = threading.Lock()


def _visible(
    sq: int, sk: int, q_offset: int, k_offset: int, causal: bool,
    sq_real: int, sk_real: int, device: torch.device,
) -> torch.Tensor:
    """[sq, sk] mask of ``_block_scores``: inside the real lengths and,
    when causal, at or below the diagonal in global positions."""
    rows = torch.arange(sq, device=device)
    cols = torch.arange(sk, device=device)
    mask = (rows[:, None] < sq_real) & (cols[None, :] < sk_real)
    if causal:
        mask = mask & ((q_offset + rows)[:, None] >= (k_offset + cols)[None, :])
    return mask


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float, mask: torch.Tensor) -> torch.Tensor:
    """f32 scores with q scaled first, as the kernels compute them; −inf
    outside ``mask``."""
    scores = torch.matmul(q.float() * scale, k.float().transpose(1, 2))
    return torch.where(mask, scores, float("-inf"))


def attend_partials_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_offset: int, k_offset: int, causal: bool, scale: float,
    sq_real: int, sk_real: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K3: ``_block_attend`` of the ring module with the
    kernel's sq_real/sk_real masks, in f32 throughout as the kernel
    computes (q scaled in f32 before the product)."""
    sq, sk = q.shape[1], k.shape[1]
    mask = _visible(sq, sk, q_offset, k_offset, causal, sq_real, sk_real, q.device)
    scores = _scores(q, k, scale, mask)
    if sk:
        m = scores.amax(dim=-1)
    else:
        m = torch.full(scores.shape[:2], float("-inf"), device=q.device)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(mask, torch.exp(scores - m_safe[..., None]), 0.0)
    return torch.matmul(p, v.float()), m, p.sum(dim=-1)


def _check_qkv(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What the kernels take: contiguous bf16 or f32 q [bh, sq, d] and
    k/v [bh, sk, d] of one dtype on one CUDA device."""
    device = q.device
    if device.type != "cuda" or k.device != device or v.device != device:
        raise ValueError(f"{what}: q, k and v must share one CUDA device")
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
        q.dtype == k.dtype == v.dtype
    ):
        raise ValueError(
            f"{what} takes bf16 or f32 q/k/v of one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if (
        q.dim() != 3 or k.shape != v.shape or k.dim() != 3
        or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]
    ):
        raise ValueError(
            f"{what} shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}"
        )
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{what} takes contiguous q/k/v")


def attend_partials(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_offset: int, k_offset: int, causal: bool, scale: float,
    sq_real: Optional[int] = None, sk_real: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward partials (pv f32, raw m, l) of q [bh, sq, d] against k/v
    [bh, sk, d]; ``sq_real``/``sk_real`` default to the full lengths.
    For bf16 q whose head dim is not a multiple of 8, or whose q/k/v
    bases are not 16-byte aligned, the kernel runs on zero-padded copies
    (counted in ``PADDED``) and pv is cut back to d columns: zero
    columns change no score and add only zero pv columns."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    sq_real = sq if sq_real is None else int(sq_real)
    sk_real = sk if sk_real is None else int(sk_real)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return attend_partials_plain(
            q, k, v, q_offset, k_offset, causal, scale, sq_real, sk_real
        )
    _check_qkv("attend_partials", q, k, v)
    device = q.device
    lib = kernels.lib("flash_attention_fwd")
    if d > lib.tsnp_flash_fwd_max_head_dim():
        raise ValueError(f"head dim {d} above the kernel's maximum")
    d_run = d
    if q.dtype == torch.bfloat16:
        d_run = -(-d // 8) * 8
        if d_run != d or any(t.data_ptr() % 16 for t in (q, k, v)):
            q, k, v = (_pad_head_dim(t, d_run) for t in (q, k, v))
            with _COUNT_LOCK:
                PADDED["flash_fwd"] += 1
    pv = torch.empty((bh, sq, d_run), dtype=torch.float32, device=device)
    m = torch.empty((bh, sq), dtype=torch.float32, device=device)
    l = torch.empty((bh, sq), dtype=torch.float32, device=device)
    if bh and sq:
        rc = lib.tsnp_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            pv.data_ptr(), m.data_ptr(), l.data_ptr(),
            bh, sq, sk, d_run, float(scale), int(bool(causal)),
            int(q_offset), int(k_offset), sq_real, sk_real,
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(device).cuda_stream,
        )
        kernels.check(rc, "flash_fwd")
        with _COUNT_LOCK:
            LAUNCHES["flash_fwd"] += 1
    if d_run != d:
        pv = pv[..., :d].contiguous()
    return pv, m, l


def flash_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    m: torch.Tensor, gpv: torch.Tensor, gl: torch.Tensor,
    q_offset: int, k_offset: int, causal: bool, scale: float,
    sq_real: int, sk_real: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K4 + K5 with full f32 score matrices: p from the
    saved m (m_safe), ds = p (gpv·v + gl), dq = scale ds k,
    dv = pᵀ gpv, dk = dsᵀ (scale q), and the first column attaining each
    row's max of the recomputed scores (−1 when the row sees none)."""
    sq, sk = q.shape[1], k.shape[1]
    mask = _visible(sq, sk, q_offset, k_offset, causal, sq_real, sk_real, q.device)
    scores = _scores(q, k, scale, mask)
    p = torch.where(mask, torch.exp(scores - m[..., None]), 0.0)
    gpv = gpv.float()
    ds = p * (torch.matmul(gpv, v.float().transpose(1, 2)) + gl[..., None])
    dq = scale * torch.matmul(ds, k.float())
    dv = torch.matmul(p.transpose(1, 2), gpv)
    dk = torch.matmul(ds.transpose(1, 2), q.float() * scale)
    if sk:
        row_max = scores.amax(dim=-1, keepdim=True)
        cols = torch.arange(sk, device=q.device).expand_as(scores)
        first = torch.where(mask & (scores == row_max), cols, sk).amin(dim=-1)
        amax = torch.where(first < sk, first, -1).to(torch.int32)
    else:
        amax = torch.full((q.shape[0], sq), -1, dtype=torch.int32, device=q.device)
    return dq, dk, dv, amax


def flash_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    m: torch.Tensor, gpv: torch.Tensor, gl: torch.Tensor,
    q_offset: int, k_offset: int, causal: bool, scale: float,
    sq_real: Optional[int] = None, sk_real: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of the partials without the g_m term: q [bh, sq, d], k/v
    [bh, sk, d], the forward's m_safe and the cotangent gl as f32
    [bh, sq], gpv [bh, sq, d] as f32 or bf16 → f32 (dq, dk, dv) and the
    i32 row argmax ``amax`` [bh, sq].  K4 computes dq and amax, K5 dk and
    dv.  The kernels take gpv in q's dtype: for bf16 q an f32 gpv is
    rounded to bf16 once, to nearest even (the tensor cores take it in
    bf16), for f32 q a bf16 gpv is widened exactly.  For bf16 q whose
    head dim is not a multiple of 8, or whose q/k/v/gpv bases are not
    16-byte aligned, the kernels run on zero-padded copies (counted in
    ``PADDED``): zero columns change no score and no output."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    sq_real = sq if sq_real is None else int(sq_real)
    sk_real = sk if sk_real is None else int(sk_real)
    if all(t.device.type == "cpu" for t in (q, k, v, m, gpv, gl)):
        return flash_bwd_plain(
            q, k, v, m, gpv, gl, q_offset, k_offset, causal, scale, sq_real, sk_real
        )
    _check_qkv("flash_bwd", q, k, v)
    device = q.device
    for name, t, shape, dtypes in (
        ("m", m, (bh, sq), (torch.float32,)),
        ("gl", gl, (bh, sq), (torch.float32,)),
        ("gpv", gpv, (bh, sq, d), (torch.float32, torch.bfloat16)),
    ):
        if (
            t.device != device or t.dtype not in dtypes
            or tuple(t.shape) != shape or not t.is_contiguous()
        ):
            raise ValueError(
                f"flash_bwd takes a contiguous {name} of shape {shape} in "
                f"{'/'.join(str(x) for x in dtypes)} on {device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
    lib_dq = kernels.lib("flash_attention_bwd_dq")
    lib_dkv = kernels.lib("flash_attention_bwd_dkv")
    if d > lib_dq.tsnp_flash_bwd_dq_max_head_dim():
        raise ValueError(f"head dim {d} above the kernel's maximum")
    gpv = gpv.to(q.dtype)
    d_run = d
    if q.dtype == torch.bfloat16:
        d_run = -(-d // 8) * 8
        if d_run != d or any(t.data_ptr() % 16 for t in (q, k, v, gpv)):
            q, k, v, gpv = (_pad_head_dim(t, d_run) for t in (q, k, v, gpv))
            with _COUNT_LOCK:
                PADDED["flash_bwd"] += 1
    dq = torch.empty((bh, sq, d_run), dtype=torch.float32, device=device)
    amax = torch.empty((bh, sq), dtype=torch.int32, device=device)
    dk = torch.empty((bh, sk, d_run), dtype=torch.float32, device=device)
    dv = torch.empty((bh, sk, d_run), dtype=torch.float32, device=device)
    args = (
        bh, sq, sk, d_run, float(scale), int(bool(causal)), int(q_offset), int(k_offset),
        sq_real, sk_real, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(device).cuda_stream,
    )
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(), gpv.data_ptr(), gl.data_ptr())
    if bh and sq:
        rc = lib_dq.tsnp_flash_bwd_dq(*ins, dq.data_ptr(), amax.data_ptr(), *args)
        kernels.check(rc, "flash_bwd_dq")
        with _COUNT_LOCK:
            LAUNCHES["flash_bwd_dq"] += 1
    if bh and sk:
        rc = lib_dkv.tsnp_flash_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(), *args)
        kernels.check(rc, "flash_bwd_dkv")
        with _COUNT_LOCK:
            LAUNCHES["flash_bwd_dkv"] += 1
    if d_run != d:
        dq, dk, dv = (t[..., :d].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv, amax


def _pad_head_dim(x: torch.Tensor, d_pad: int) -> torch.Tensor:
    """x [..., d] zero-padded to [..., d_pad] in a fresh contiguous tensor
    (so also 16-byte aligned when d_pad is a multiple of 8 for bf16)."""
    out = x.new_zeros((*x.shape[:-1], d_pad))
    out[..., : x.shape[-1]] = x
    return out


def _to_bh(x: torch.Tensor) -> torch.Tensor:
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d).contiguous()


def _from_bh(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """[b*h, s, d] → [b, s, h, d]."""
    return x.reshape(b, h, x.shape[1], x.shape[2]).permute(0, 2, 1, 3)


def _flash_bwd(
    q_bh: torch.Tensor, k_bh: torch.Tensor, v_bh: torch.Tensor,
    pv: torch.Tensor, m_safe: torch.Tensor, l: torch.Tensor,
    g_pv: torch.Tensor, g_m: torch.Tensor, g_l: torch.Tensor,
    q_offset: int, k_offset: int, causal: bool, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of the partials contract (pv, m, l) → f32 (dq, dk, dv)
    in the [b*h, s, d] layout: the row term T_i = gpv_i·pv_i + l_i·gl_i
    collapses the row sum the standard flash backward recomputes, the
    kernels (or their plain version) run without the g_m term, and the
    g_m term is applied here on their ``amax``: a gather of k for dq and
    a scatter-add of scale·(g_m − T)·q into dk (many rows may share one
    argmax column, so it accumulates).  Rows with no valid column (amax
    = −1) contribute nothing."""
    b, sq, h, d = pv.shape
    sk = k_bh.shape[1]
    gpv_bh = _to_bh(g_pv)  # in pv's dtype: bf16 on the bf16 path, as the kernels take it
    flat = lambda x: x.reshape(b * h, x.shape[2]).float().contiguous()  # noqa: E731
    T = torch.einsum("bshd,bshd->bhs", g_pv.float(), pv.float()) + l * g_l
    gmt = flat(g_m.float() - T)
    dq, dk, dv, amax = flash_bwd(
        q_bh, k_bh, v_bh, flat(m_safe), gpv_bh, flat(g_l),
        q_offset, k_offset, causal, scale,
    )
    if sk:
        gmt = torch.where(amax >= 0, gmt, 0.0)[..., None]
        idx = amax.clamp(0, sk - 1).long()[..., None].expand(-1, -1, d)
        dq = dq + scale * gmt * torch.gather(k_bh.float(), 1, idx)
        dk = dk.scatter_add(1, idx, scale * gmt * q_bh.float())
    return dq, dk, dv


class _DiffPartials(torch.autograd.Function):
    """``flash_attention_partials`` with the flash backward as its
    gradient: the counterpart of ``_make_diff_partials``' custom_vjp."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, k_offset, causal, scale):
        b, sq, h, d = q.shape
        q_bh, k_bh, v_bh = _to_bh(q), _to_bh(k), _to_bh(v)
        pv, m, l = attend_partials(q_bh, k_bh, v_bh, q_offset, k_offset, causal, scale)
        pv = _from_bh(pv, b, h).to(v.dtype)
        m = m.reshape(b, h, sq)
        l = l.reshape(b, h, sq)
        m_safe = torch.where(torch.isfinite(m), m, 0.0)
        # a fully-masked row has every softmax term zeroed → l == 0
        valid = l > 0.0
        ctx.mark_non_differentiable(valid)
        ctx.save_for_backward(q_bh, k_bh, v_bh, pv, m_safe, l)
        ctx.args = (q_offset, k_offset, causal, scale, q.dtype, k.dtype, v.dtype, b, h)
        return pv, m_safe, l, valid

    @staticmethod
    @once_differentiable
    def backward(ctx, g_pv, g_m, g_l, _g_valid):
        q_bh, k_bh, v_bh, pv, m_safe, l = ctx.saved_tensors
        q_offset, k_offset, causal, scale, q_dt, k_dt, v_dt, b, h = ctx.args
        dq, dk, dv = _flash_bwd(
            q_bh, k_bh, v_bh, pv, m_safe, l, g_pv, g_m, g_l,
            q_offset, k_offset, causal, scale,
        )
        return (
            _from_bh(dq, b, h).to(q_dt), _from_bh(dk, b, h).to(k_dt),
            _from_bh(dv, b, h).to(v_dt), None, None, None, None,
        )


def flash_attention_partials(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_offset: int, k_offset: int, causal: bool, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """q: [b, sq, h, d]; k/v: [b, sk, h, d].  Returns (pv [b, sq, h, d]
    in v's dtype, m_safe [b, h, sq], l [b, h, sq], valid [b, h, sq]),
    differentiable in q, k and v through the flash backward."""
    return _DiffPartials.apply(q, k, v, int(q_offset), int(k_offset), bool(causal), float(scale))


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """Normalised flash attention on one shard: [b, s, h, d] → same."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    pv, _, l, _ = flash_attention_partials(q, k, v, 0, 0, causal, scale)
    denom = torch.where(l == 0.0, 1.0, l)  # fully-masked rows → 0 output
    out = pv.float() / denom.permute(0, 2, 1)[..., None]
    return out.to(q.dtype)
