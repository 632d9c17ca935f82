#!/usr/bin/env python3
"""Drive the PyTorch port end to end on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (the kernels are built from ``csrc/`` on
first use), ``g++`` (the native fast-I/O library is built from
``_csrc/fastio.cpp`` on first use; the script fails when it does not
build) and a writable temporary directory (the snapshot is written
under ``$TMPDIR``).  It exits non-zero, printing no result, when there
is no card or anything below fails.  In order:

1. prints the card (``nvidia-smi`` name and power limit);
2. builds the CUDA kernels (K1 slab pack, K2 slab unpack, K3 flash-
   attention forward, K4/K5 flash-attention backward dq and dk/dv), one
   nvcc each, in parallel, prints what ptxas reports for them, and
   fails on a spill or a serialised ``wgmma`` (C75xx);
3. kernel phase: holds each kernel against its plain PyTorch version on
   the card at the main path's shapes and times both, plus one PyTorch
   library call computing the same function where there is one.
   Tolerances: K1 and K2 bitwise; K3 m atol 1e-3 and pv/l normalised
   within 2e-2 (bf16 operands, another summation order); K4/K5 dq, dk,
   dv within 2e-2 of the largest plain value (ds and gpv enter the
   tensor cores in bf16) and the argmax exactly on rows whose top two
   scores are apart by more than the summation order can move them (the
   ``kernels`` line carries each kernel's own outputs' absolute error;
   K3's record adds its normalised pv error), K3-K5 at s = 2048, on
   ragged and q_offset cases (K4/K5 also s = 2047), with a second call
   bitwise equal to the first.  K1 packs the take's first device slab
   and the same members each followed by a 4-byte f32 scalar (the step
   a fused AdamW keeps on the card), which puts them off 16-byte
   alignment; K2 unpacks both slabs.  K6 casts 32 MiB bf16 tiles of the
   embedding into an f32 template at offset 0 and as the last, ragged
   tile, bitwise.  Every kernel, its plain version and the library
   yardstick (``torch.cat`` for K1, SDPA forward for K3, SDPA backward
   for K4 + K5, ``copy_`` into the template's range for K6) are timed 5
   times: median, range, share of the bound, TFLOP/s for K3-K5; K1 both
   as ``pack_slab`` is called and as its launch alone;
4. seven paths, each with the launch counters set to 0 just before it
   and read just after (a path that starts processes adds the launches
   they report), all with the fast-I/O engine at its defaults unless
   the path says otherwise:
   a. serving, at full width: the repo's transformer (TransformerConfig
      defaults, depth cut to 2 layers, bf16, ~0.67 B parameters) takes
      one AdamW step, is snapshotted with ``Snapshot.take``, restored
      into a differently seeded model and optimizer, and checked
      bitwise (every tensor, the logits on a fixed batch, the step
      counter, ``read_object``); then ring attention (ring size 1, so
      K3) on q/k/v projected from the restored layer-0 weights at
      s = 2048 against dense attention computed in f32 (tolerance 2e-2);
   a2. fastio (after a, on a's state): take and restore under FASTIO=0
      (the fs plugin's pure-Python legs), FASTIO=1 (the native engine,
      digests fused into its writes) and FASTIO=1 + FASTIO_DIRECT=1
      (O_DIRECT where the work directory takes it), 3 times each in
      alternating order, each snapshot deleted after use: every restore
      bitwise, every manifest's digests equal; it prints the library,
      whether O_DIRECT is active, each setting's median and range and
      its seven ``storage.fastio`` counters.  After c it also prints
      the host digest rates: zlib against the native one-pass digest
      over the same 256 MiB, which must agree;
   b. ring-attention gradient: ``torch.autograd.grad`` of the bf16 ring
      output on those q/k/v (K3 forward, K4/K5 backward) against f32
      dense attention's autograd gradient (tolerance 3e-2 of the largest
      gradient);
   c. resumable training at full width, s = 2048, on a batch sized from
      the measured step peak (plus a ballast tensor) so that the step
      fills the card up to where half of the state's device copies fit
      beside the next one: ``train_step``, a host clone of the state,
      ``Snapshot.async_take`` (device copies within its budget, blocking
      pinned copies past it), the next ``train_step`` at once (it
      changes the state in place while the snapshot drains), ``wait()``,
      restore into a differently seeded model and optimizer: every
      tensor bitwise equal to the clone, and the step after the restore
      gives the same loss bitwise;
   d. budgeted reads (after b, out of a's snapshot, at full width):
      ``read_object`` of the embedding and the LM head, and of the
      embedding chunked into 64 MiB chunks, with a 32 MiB budget into
      bf16 CUDA templates (copies only), f32 CUDA templates (K6), no
      template (a fresh CUDA tensor) and CPU templates, each bitwise;
      again under VERIFY_ON_RESTORE=1, and a corrupted copy that must
      raise while its template stays usable.  Each read prints its
      tiles, seconds, pinned tile high-water mark (at most the budget
      and one tile) and the rise in allocated device memory;
   e. many ranks (after c, the parent holding no state): two processes
      on the card over a TCPStore on localhost (gloo initialized for the
      store only), each with the full-width model and AdamW state marked
      ``Replicated`` plus state of its own: a sync take at world 2 (each
      rank writes 40-60% of the replicated bytes), restore at world 2,
      ``async_take`` with its commit barrier, and a take in which rank
      1's storage fails (both raise within 10 s, rank 0 a
      ``SnapshotAbortedError``, no metadata); then a restore at world 1
      in this process, bitwise;
   f. sharded (after e): the same full-width state as DTensors laid out
      by ``parallel/mesh.py``'s rules (embedding, LM head, wq/wk/wv/w1/
      gate split over dim 1, wo/w2 over dim 0, norms replicated, each
      AdamW moment as its parameter), stored boxes split at 64 MiB.  In
      this process, on a 1-rank CUDA mesh of (1, 1) named ("dp", "tp")
      over gloo: sync take, ``async_take`` and ``wait()``, restores into
      bf16 DTensors, f32 DTensors (K6) and plain CUDA tensors, and a
      budgeted ``read_object`` of the embedding, each bitwise.  Then two
      processes on the card over gloo, DTensors on a 1-D "tp" CUDA mesh
      of 2 (on the CPU if such a mesh cannot be built; the result line
      says which): a take at world 2 (each rank writes 40-60% of the
      bytes) and a restore at world 2 into the transposed layout; then,
      in this process, the restore at world 1 of that snapshot onto the
      (1, 1) mesh and into plain tensors, bitwise.  No box may miss the
      device path (``TILE_MISSES``).

Every kernel must have launched on these paths, and each path on the
kernels it runs.  The line before the last is the card; the line before
it the ``kernels`` JSON; the last line ``{"ok": true, "device": ...}``.
"""

import gc
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import torch

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import batcher
from torchsnapshot_tpu_torch.batcher import BatchedBufferStager, batch_write_requests
from torchsnapshot_tpu_torch.flatten import flatten
from torchsnapshot_tpu_torch import host_offload
from torchsnapshot_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    make_train_state,
    train_step,
)
from torchsnapshot_tpu_torch.ops import device_pack, flash_attention, kernels
from torchsnapshot_tpu_torch.parallel.ring_attention import dense_attention, ring_attention
from torchsnapshot_tpu_torch.preparers import array as array_preparer
from torchsnapshot_tpu_torch.preparers import prepare_write
from torchsnapshot_tpu_torch.serialization import dtype_to_string

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bandwidth, bf16 tensor rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
N_LAYERS = 2
SEQ = 2048
READ_BUDGET = 32 << 20  # the budgeted reads' memory_budget_bytes


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters=20, warmup=3):
    """Device time of one ``fn()`` call: CUDA events around ``iters``
    calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(t):
    return t.numel() * t.element_size()


def span_summary():
    return json.dumps({k: round(v, 4) for k, v in sorted(tts.obs.span_totals().items())})


def first_device_slab(model):
    """The member tensors of the first slab ``Snapshot.take`` packs on the
    device for this model (same planning code as the take)."""
    _, flat = flatten(model.state_dict(), prefix="model")
    entries, reqs = {}, []
    for path in sorted(flat):
        entry, wr = prepare_write(flat[path], path, rank=0)
        entries[path] = entry
        reqs.extend(wr)
    _, reqs = batch_write_requests(entries, reqs, 0)
    for wr in reqs:
        s = wr.buffer_stager
        if isinstance(s, BatchedBufferStager) and s.on_device:
            return [st.tensor for st, _ in s.stagers]
    raise RuntimeError("the plan has no device slab")


def kernel_record(name, source, replaces, err, ms, plain_ms, bound_ms, bound_by, library_ms):
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


def interleave_steps(members):
    """``members`` each followed by a 4-byte f32 CUDA scalar, the ``step``
    that ``torch.optim.AdamW(fused=True)`` keeps on the card beside every
    parameter: in the slab every member after the first then sits at 4,
    8, 12, ... mod 16, as the batcher's path order puts them."""
    out = []
    for i, t in enumerate(members):
        out += [t, torch.full((), float(i + 1), device=t.device)]
    return out


def pack_launch(members):
    """K1's launch alone, its table built beforehand (as ``pack_slab``
    builds it): a callable returning the launch's error code."""
    lib = kernels.lib("slab_pack")
    plan, total_chunks, total = device_pack.pack_plan(
        [nbytes(t) for t in members], lib.tsnp_slab_pack_chunk_bytes()
    )
    table, on_device = device_pack.descriptor_table(
        [(t.data_ptr(), *row) for t, row in zip(members, plan)],
        lib.tsnp_slab_pack_inline_members(), members[0].device,
    )
    slab = torch.empty(total, dtype=torch.uint8, device=members[0].device)
    stream = torch.cuda.current_stream().cuda_stream
    return lambda: lib.tsnp_slab_pack(table.data_ptr(), on_device, len(plan), total_chunks,
                                      slab.data_ptr(), stream)


def fmt_t(t):
    return f"{t[0]:.4f} ms ({t[1]:.4f}-{t[2]:.4f})"


def phase_k1(members):
    """K1 on the take's first device slab (aligned members) and on the same
    members interleaved with 4-byte scalars (misaligned), bitwise against
    the plain version; ``pack_slab`` as called and its launch alone, with
    ``torch.cat`` of the same bytes as the yardstick, 5 timings each."""
    out = {}
    for what, ms in (("aligned", members), ("misaligned", interleave_steps(members))):
        total = sum(nbytes(t) for t in ms)
        got = device_pack.pack_slab(ms)
        want = device_pack.pack_slab_plain(ms)
        check(torch.equal(got, want), f"K1 {what} slab differs from its plain version")
        err = float((got.int() - want.int()).abs().max()) if total else 0.0
        launch = pack_launch(ms)
        kernels.check(launch(), f"slab_pack {what}")
        views = [t.reshape(-1).view(torch.uint8) for t in ms]
        call_t = time_ms_repeats(lambda: device_pack.pack_slab(ms))
        launch_t = time_ms_repeats(launch)
        cat_t = time_ms_repeats(lambda: torch.cat(views))
        bound_ms = 2 * total / HBM_BYTES_PER_S * 1e3
        out[what] = (ms, got, total, err, call_t, launch_t, cat_t, bound_ms)
        print(f"K1 {what}: {len(ms)} members, {total} bytes; pack_slab as called {fmt_t(call_t)}, "
              f"launch alone {fmt_t(launch_t)}, torch.cat {fmt_t(cat_t)}; bound {bound_ms:.4f} ms "
              f"({100 * bound_ms / call_t[0]:.1f}% as called, {100 * bound_ms / launch_t[0]:.1f}% "
              f"launch alone); {total / call_t[0] / 1e6:.1f} GB/s of slab")
    _, got, total, err, call_t, launch_t, cat_t, bound_ms = out["aligned"]
    mis = out["misaligned"]
    per_byte = (mis[4][0] / mis[2]) / (call_t[0] / total)
    plain_t = time_ms_repeats(lambda: device_pack.pack_slab_plain(members), iters=5)
    host = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    d2h_ms = time_ms(lambda: host.copy_(got, non_blocking=True), iters=5)
    print(f"K1 misaligned time per byte / aligned: {per_byte:.3f}; plain {fmt_t(plain_t)}; pinned D2H "
          f"of the aligned slab {d2h_ms:.3f} ms ({total / d2h_ms / 1e6:.2f} GB/s)")
    record = kernel_record(
        "slab_pack", "torchsnapshot_tpu_torch/csrc/slab_pack.cu",
        "torchsnapshot_tpu/ops/device_pack.py:23", max(err, mis[3]), call_t[0], plain_t[0],
        bound_ms, "bytes", cat_t[0],
    )
    record.update(launch_ms=launch_t[0], misaligned_ms=mis[4][0], misaligned_launch_ms=mis[5][0],
                  misaligned_bound_ms=mis[7], misaligned_library_ms=mis[6][0])
    return got, mis[0], mis[1], record


def unpack_layout(members):
    layout, off = [], 0
    for t in members:
        layout.append((off, dtype_to_string(t.dtype), tuple(t.shape)))
        off += nbytes(t)
    return layout


def phase_k2(slab, members, mis_slab, mis_members):
    """Unpack the K1 slab plus a bool member, casting member 0 bf16 → f32;
    and the misaligned K1 slab into aligned templates of the stored
    dtypes (identity members at 4, 8, 12 mod 16).  Both bitwise against
    the plain version, 5 timings each."""
    g = torch.Generator(device="cuda").manual_seed(2)
    flags = torch.rand(4099, device="cuda", generator=g) > 0.5
    slab = torch.cat([slab, flags.view(torch.uint8)])
    layout = unpack_layout(members + [flags])
    out_dtypes = [torch.float32] + [t.dtype for t in members[1:]] + [torch.bool]
    outs = [torch.empty(t.shape, dtype=d, device="cuda") for t, d in zip(members + [flags], out_dtypes)]
    mis_layout = unpack_layout(mis_members)
    mis_dtypes = [t.dtype for t in mis_members]
    mis_outs = [torch.empty_like(t) for t in mis_members]
    times = {}
    for what, sl, lay, dts, os_ in (("aligned", slab, layout, out_dtypes, outs),
                                     ("misaligned", mis_slab, mis_layout, mis_dtypes, mis_outs)):
        device_pack.unpack_slab_into(sl, lay, os_)
        want = device_pack.unpack_slab_plain(sl, lay, dts)
        for o, w in zip(os_, want):
            check(o.dtype == w.dtype and torch.equal(o, w), f"K2 {what} output differs from its plain version")
        times[what] = time_ms_repeats(lambda sl=sl, lay=lay, os_=os_: device_pack.unpack_slab_into(sl, lay, os_))
    check(all(torch.equal(o, t) for o, t in zip(mis_outs, mis_members)), "K2 misaligned: members differ")
    out_bytes = sum(nbytes(o) for o in outs)
    bound_ms = (nbytes(slab) + out_bytes) / HBM_BYTES_PER_S * 1e3
    mis_bound_ms = 2 * nbytes(mis_slab) / HBM_BYTES_PER_S * 1e3

    def plain_into():
        # the plain version plus the copy into the templates the kernel
        # writes (identity members decode to views of the slab)
        for o, w in zip(outs, device_pack.unpack_slab_plain(slab, layout, out_dtypes)):
            o.copy_(w)

    plain_t = time_ms_repeats(plain_into, iters=5)
    print(f"K2 aligned (member 0 cast bf16 -> f32): {fmt_t(times['aligned'])}, bound {bound_ms:.4f} ms "
          f"({100 * bound_ms / times['aligned'][0]:.1f}%); misaligned identity: {fmt_t(times['misaligned'])}, "
          f"bound {mis_bound_ms:.4f} ms ({100 * mis_bound_ms / times['misaligned'][0]:.1f}%); "
          f"plain {fmt_t(plain_t)}")
    record = kernel_record(
        "slab_unpack", "torchsnapshot_tpu_torch/csrc/slab_unpack.cu",
        "torchsnapshot_tpu/ops/device_pack.py:85", 0.0, times["aligned"][0], plain_t[0],
        bound_ms, "bytes", None,
    )
    record.update(misaligned_ms=times["misaligned"][0], misaligned_bound_ms=mis_bound_ms)
    return record


def phase_k6(cfg):
    """K6 at full width: 32 MiB bf16 tiles of the embedding (vocab x d_model
    bf16, the budgeted read's tile size) cast into an f32 template, at
    offset 0 and as the last, ragged tile; bitwise against
    ``tile_update_plain``.  The full tile timed 5 times beside the plain
    version and the one PyTorch call computing the same thing,
    ``dst.view(-1)[off:off + n].copy_(tile)``."""
    g = torch.Generator(device="cuda").manual_seed(5)
    total = cfg.vocab * cfg.d_model
    emb = torch.randn(total, device="cuda", generator=g).to(torch.bfloat16)
    dst = torch.zeros(total, dtype=torch.float32, device="cuda")
    want = torch.zeros_like(dst)
    n_tile = READ_BUDGET // emb.element_size()
    last = (total - 1) // n_tile * n_tile
    err = 0.0
    for off in (0, last):
        tile = emb[off:off + n_tile]
        device_pack.tile_update(dst, off, tile)
        device_pack.tile_update_plain(want, off, tile)
        torch.cuda.synchronize()
        check(torch.equal(dst, want), f"K6 tile at {off} ({tile.numel()} elements) differs from its plain version")
        check(torch.equal(dst[off:off + tile.numel()], tile.float()), f"K6 tile at {off}: not the cast tile")
        err = max(err, float((dst - want).abs().max()))
    print(f"K6: bf16 -> f32 tiles of {n_tile} and {total - last} elements (offsets 0 and {last}) "
          "bitwise equal to the plain version")
    tile = emb[:n_tile]
    k6_t = time_ms_repeats(lambda: device_pack.tile_update(dst, 0, tile))
    plain_t = time_ms_repeats(lambda: device_pack.tile_update_plain(want, 0, tile))
    copy_t = time_ms_repeats(lambda: dst.view(-1)[0:n_tile].copy_(tile))
    bound_ms = (nbytes(tile) + n_tile * 4) / HBM_BYTES_PER_S * 1e3
    print(f"K6 timings, median of 5 (range), one {nbytes(tile)}-byte bf16 tile into f32: tile_update "
          f"{fmt_t(k6_t)}, {100 * bound_ms / k6_t[0]:.1f}% of its {bound_ms:.4f} ms bound "
          f"({(nbytes(tile) + n_tile * 4) / k6_t[0] / 1e6:.1f} GB/s); copy_ {fmt_t(copy_t)}; "
          f"plain {fmt_t(plain_t)}")
    return kernel_record(
        "tile_update", "torchsnapshot_tpu_torch/csrc/tile_update.cu",
        "torchsnapshot_tpu/ops/device_pack.py:138", err, k6_t[0], plain_t[0], bound_ms, "bytes",
        copy_t[0],
    )


def compare_partials(got, want, what):
    """Holds K3's partials to their tolerances; returns the normalised pv
    error and the largest absolute error of the kernel's own outputs (pv,
    finite m, l)."""
    pv, m, l = got
    wpv, wm, wl = want
    finite = torch.isfinite(wm)
    check(torch.equal(torch.isfinite(m), finite), f"{what}: masked rows differ")
    m_err = float((m - wm).abs()[finite].max()) if bool(finite.any()) else 0.0
    check(m_err <= 1e-3, f"{what}: m beyond atol 1e-3")
    denom = lambda x: torch.where(x == 0, 1.0, x)[..., None]  # noqa: E731
    err = float((pv / denom(l) - wpv / denom(wl)).abs().max())
    check(err <= 2e-2, f"{what}: normalised pv error {err} beyond 2e-2")
    check(bool(((l - wl).abs() <= 2e-2 * wl.abs() + 2e-2).all()), f"{what}: l beyond 2e-2")
    abs_err = max(float((pv - wpv).abs().max()), m_err, float((l - wl).abs().max()))
    return err, abs_err


def phase_k3():
    g = torch.Generator(device="cuda").manual_seed(3)
    bh, d = 32, 128
    scale = 1.0 / d ** 0.5

    def qkv(sq, sk):
        mk = lambda n: torch.randn((bh, n, d), device="cuda", generator=g).to(torch.bfloat16)  # noqa: E731
        return mk(sq), mk(sk), mk(sk)

    cases = [("main", SEQ, SEQ, 0, 0), ("ragged", 2000, 1900, 0, 0), ("q_offset", 1024, SEQ, 1024, 0)]
    for what, sq, sk, qo, ko in cases:
        q, k, v = qkv(sq, sk)
        got = flash_attention.attend_partials(q, k, v, qo, ko, True, scale)
        want = flash_attention.attend_partials_plain(q, k, v, qo, ko, True, scale, sq, sk)
        err, abs_err = compare_partials(got, want, f"K3 {what}")
        print(f"K3 {what} (sq={sq}, sk={sk}, q_offset={qo}): normalised pv error {err:.3e}, "
              f"max abs err of pv, m, l {abs_err:.3e}")
        if what == "main":
            again = flash_attention.attend_partials(q, k, v, qo, ko, True, scale)
            for name, a, b in zip(("pv", "m", "l"), got, again):
                check(torch.equal(a, b), f"K3: a second call gives other bits in {name}")
            print("K3 main: a second call gives the same pv, m and l bitwise")
            main_err, main = (err, abs_err), (q, k, v)
        del got, want
    q, k, v = main
    # the launch alone, as K4/K5 are timed, and attend_partials as called
    lib = kernels.lib("flash_attention_fwd")
    outs = [torch.empty((bh, SEQ, d), device="cuda"), torch.empty((bh, SEQ), device="cuda"),
            torch.empty((bh, SEQ), device="cuda")]
    stream = torch.cuda.current_stream().cuda_stream
    launch = lambda: lib.tsnp_flash_fwd(  # noqa: E731
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *(t.data_ptr() for t in outs),
        bh, SEQ, SEQ, d, scale, 1, 0, 0, SEQ, SEQ, 1, stream)
    kernels.check(launch(), "flash_fwd")
    k3_t = time_ms_repeats(launch)
    called_t = time_ms_repeats(lambda: flash_attention.attend_partials(q, k, v, 0, 0, True, scale))
    plain_t = time_ms_repeats(
        lambda: flash_attention.attend_partials_plain(q, k, v, 0, 0, True, scale, SEQ, SEQ), repeats=3, iters=3
    )
    qs, ks, vs = (t.unsqueeze(0) for t in (q, k, v))  # [1, h, s, d]
    sdpa_t = time_ms_repeats(
        lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    )
    flops = 4 * bh * d * causal_pairs(SEQ, SEQ, 0)
    io_bytes = 3 * bh * SEQ * d * 2 + bh * SEQ * d * 4 + 2 * bh * SEQ * 4
    t_ops, t_bytes = flops / BF16_FLOP_PER_S, io_bytes / HBM_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    print(f"K3 timings, median of 5 (range): flash_attention_fwd {fmt_t(k3_t)}, "
          f"{flops / k3_t[0] / 1e9:.1f} TFLOP/s, {100 * bound_ms / k3_t[0]:.1f}% of its {bound_ms:.4f} ms "
          f"bound; attend_partials as called {fmt_t(called_t)}; SDPA forward {fmt_t(sdpa_t)} "
          f"({flops / sdpa_t[0] / 1e9:.1f} TFLOP/s, bf16 output, K3 writes pv in f32); plain {fmt_t(plain_t)}")
    record = kernel_record(
        "flash_attention_fwd", "torchsnapshot_tpu_torch/csrc/flash_attention_fwd.cu",
        "torchsnapshot_tpu/ops/flash_attention.py:136", main_err[1], k3_t[0], plain_t[0],
        bound_ms, "operations" if t_ops >= t_bytes else "bytes", sdpa_t[0],
    )
    record.update(normalised_pv_err=main_err[0], called_ms=called_t[0])
    return record


def causal_pairs(sq, sk, q_offset):
    """(query, key) pairs a causal block sees: row i sees keys ≤ q_offset + i."""
    return sum(min(sk, max(0, q_offset + i + 1)) for i in range(sq))


def time_ms_repeats(fn, repeats=5, iters=10):
    """``time_ms`` ``repeats`` times: (median, min, max)."""
    times = sorted(time_ms(fn, iters=iters) for _ in range(repeats))
    return times[len(times) // 2], times[0], times[-1]


def phase_k4_k5():
    """K4 (dq, amax) and K5 (dk, dv) against their plain version at the
    ring-attention shape (bh = 32, s = 2048, d = 128, bf16, causal), a
    ragged case, a q_offset case and a tile-edge case (s = 2047); m is
    K3's, the cotangents random.  Two calls at the main shape must give
    the same bits (no float atomics)."""
    g = torch.Generator(device="cuda").manual_seed(4)
    bh, d = 32, 128
    scale = 1.0 / d ** 0.5
    mk = lambda *shape: torch.randn(shape, device="cuda", generator=g)  # noqa: E731
    cases = [("main", SEQ, SEQ, 0), ("ragged", 2000, 1900, 0), ("q_offset", 1024, SEQ, 1024),
             ("tile_edge", SEQ - 1, SEQ - 1, 0)]
    errs = {}
    for what, sq, sk, qo in cases:
        q, k, v = (mk(bh, n, d).to(torch.bfloat16) for n in (sq, sk, sk))
        _, m, _ = flash_attention.attend_partials(q, k, v, qo, 0, True, scale)
        m = torch.where(torch.isfinite(m), m, 0.0).contiguous()
        # the ring path hands the kernels gpv in bf16 (pv is bf16)
        gpv, gl = mk(bh, sq, d).to(torch.bfloat16), mk(bh, sq)
        got = flash_attention.flash_bwd(q, k, v, m, gpv, gl, qo, 0, True, scale)
        want = flash_attention.flash_bwd_plain(q, k, v, m, gpv, gl, qo, 0, True, scale, sq, sk)
        torch.cuda.synchronize()
        if what == "main":
            again = flash_attention.flash_bwd(q, k, v, m, gpv, gl, qo, 0, True, scale)
            torch.cuda.synchronize()
            for name, a, b in zip(("dq", "dk", "dv", "amax"), got, again):
                check(torch.equal(a, b), f"K4/K5: a second call gives other bits in {name}")
            del again
            print("K4/K5 main: a second call gives the same dq, dk, dv and amax bitwise")
        case_errs = {}
        for name, a, b in zip(("dq", "dk", "dv"), got[:3], want[:3]):
            check(bool(torch.isfinite(a).all()), f"K4/K5 {what}: {name} not finite")
            abs_err = float((a - b).abs().max())
            rel = abs_err / max(float(b.abs().max()), 1e-30)
            check(rel <= 2e-2, f"K4/K5 {what}: {name} relative error {rel} beyond 2e-2")
            case_errs[name] = (abs_err, rel)
        mask = flash_attention._visible(sq, sk, qo, 0, True, sq, sk, q.device)
        top = flash_attention._scores(q, k, scale, mask).topk(2, dim=-1).values
        clear = (top[..., 0] - top[..., 1] > 1e-2 * (1 + top[..., 0].abs())) | ~torch.isfinite(top[..., 1])
        case_errs["amax_moved"] = int((got[3] != want[3]).sum())
        check(torch.equal(got[3][clear], want[3][clear]), f"K4 {what}: argmax differs on clear rows")
        print(f"K4/K5 {what} (sq={sq}, sk={sk}, q_offset={qo}): max abs err (max error / max |plain|) "
              + ", ".join(f"{n} {case_errs[n][0]:.3e} ({case_errs[n][1]:.3e})" for n in ("dq", "dk", "dv"))
              + f"; argmax: {case_errs['amax_moved']} of {bh * sq} rows differ, all within near-ties "
              f"({int(clear.sum())} clear rows equal)")
        errs[what] = case_errs
        if what == "main":
            main = (q, k, v, m, gpv, gl)
        del q, k, v, got, want, mask, top
    q, k, v, m, gpv, gl = main
    outs = [torch.empty((bh, SEQ, d), device="cuda") for _ in range(3)]
    amax = torch.empty((bh, SEQ), dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ins = [t.data_ptr() for t in (q, k, v, m, gpv, gl)]
    args = (bh, SEQ, SEQ, d, scale, 1, 0, 0, SEQ, SEQ, 1, stream)
    lib_dq, lib_dkv = kernels.lib("flash_attention_bwd_dq"), kernels.lib("flash_attention_bwd_dkv")
    # each kernel alone, as flash_bwd launches it; 5 timings of 10 calls each
    dq_t = time_ms_repeats(lambda: lib_dq.tsnp_flash_bwd_dq(*ins, outs[0].data_ptr(), amax.data_ptr(), *args))
    dkv_t = time_ms_repeats(
        lambda: lib_dkv.tsnp_flash_bwd_dkv(*ins, outs[1].data_ptr(), outs[2].data_ptr(), *args)
    )
    plain_t = time_ms_repeats(
        lambda: flash_attention.flash_bwd_plain(q, k, v, m, gpv, gl, 0, 0, True, scale, SEQ, SEQ), iters=3
    )
    # yardstick for K4 + K5 together: SDPA's backward, graph retained
    qs, ks, vs = (t.unsqueeze(0).detach().requires_grad_() for t in (q, k, v))  # [1, h, s, d]
    out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    go = torch.randn(out.shape, device="cuda", generator=g).to(out.dtype)
    sdpa_t = time_ms_repeats(lambda: torch.autograd.grad(out, (qs, ks, vs), go, retain_graph=True))
    pairs = causal_pairs(SEQ, SEQ, 0) * bh
    in_bytes = 3 * nbytes(q) + nbytes(m) + nbytes(gpv) + nbytes(gl)
    main_errs = errs["main"]
    records, lines = [], []
    # each record holds its own outputs' absolute error at the main shape
    for name, source, line, t, flop_per_pair, out_bytes, err, library_ms in (
        ("flash_attention_bwd_dq", "flash_attention_bwd_dq.cu", 293, dq_t, 6 * d,
         nbytes(outs[0]) + nbytes(amax), main_errs["dq"][0], None),
        ("flash_attention_bwd_dkv", "flash_attention_bwd_dkv.cu", 375, dkv_t, 8 * d,
         nbytes(outs[1]) + nbytes(outs[2]), max(main_errs["dk"][0], main_errs["dv"][0]), sdpa_t[0]),
    ):
        flops = flop_per_pair * pairs
        t_ops = flops / BF16_FLOP_PER_S
        t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S
        bound_ms = max(t_ops, t_bytes) * 1e3
        records.append(kernel_record(
            name, f"torchsnapshot_tpu_torch/csrc/{source}",
            f"torchsnapshot_tpu/ops/flash_attention.py:{line}",
            err, t[0], plain_t[0], bound_ms,
            "operations" if t_ops >= t_bytes else "bytes", library_ms,
        ))
        lines.append(f"{name} {t[0]:.4f} ms (range {t[1]:.4f}-{t[2]:.4f}), "
                     f"{flops / t[0] / 1e9:.1f} TFLOP/s, {100 * bound_ms / t[0]:.1f}% of its "
                     f"{bound_ms:.4f} ms bound")
    # K4's other output: argmax rows that a near-tie moved at the main shape
    records[0]["argmax_rows_moved"] = main_errs["amax_moved"]
    both = dq_t[0] + dkv_t[0]
    print(f"K4/K5 timings, median of 5 (range): {'; '.join(lines)}; K4 + K5 {both:.4f} ms, "
          f"{14 * d * pairs / both / 1e9:.1f} TFLOP/s; plain backward (both) {plain_t[0]:.3f} ms "
          f"({plain_t[1]:.3f}-{plain_t[2]:.3f}); SDPA backward (yardstick for K4 + K5) "
          f"{sdpa_t[0]:.4f} ms ({sdpa_t[1]:.4f}-{sdpa_t[2]:.4f})")
    return records


def adamw_step(model, tokens):
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=0.01)
    logits = model(tokens[:, :-1])
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1)
    )
    loss.backward()
    opt.step()
    opt.zero_grad(set_to_none=True)
    return opt


def state_bytes(model, opt):
    total = sum(nbytes(t) for t in model.state_dict().values())
    for st in opt.state_dict()["state"].values():
        total += sum(nbytes(v) for v in st.values() if isinstance(v, torch.Tensor))
    return total


def phase_main_path(cfg, model, opt, root):
    g = torch.Generator(device="cuda").manual_seed(7)
    eval_tokens = torch.randint(0, cfg.vocab, (1, 64), device="cuda", generator=g)
    with torch.no_grad():
        logits = model(eval_tokens)
    nb = state_bytes(model, opt)

    torch.cuda.synchronize()
    tts.obs.reset()
    t0 = time.perf_counter()
    snap = tts.Snapshot.take(
        root, {"model": model, "optim": opt, "rng": tts.RNGState(), "meta": tts.StateDict(step=1)}
    )
    take_s = time.perf_counter() - t0
    print(f"take span totals (s, summed over concurrent tasks): {span_summary()}")
    tts.obs.reset()

    torch.manual_seed(1)
    model2 = TransformerLM(cfg, device="cuda")
    opt2 = adamw_step(model2, torch.randint(0, cfg.vocab, (1, 65), device="cuda", generator=g))
    meta2 = tts.StateDict(step=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tts.Snapshot(root).restore({"model": model2, "optim": opt2, "rng": tts.RNGState(), "meta": meta2})
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    print(f"restore span totals (s, summed over concurrent tasks): {span_summary()}")

    for (name, a), b in zip(model.state_dict().items(), model2.state_dict().values()):
        check(a.dtype == b.dtype and torch.equal(a, b), f"restored model tensor {name} differs")
    s1, s2 = opt.state_dict(), opt2.state_dict()
    check(s1["param_groups"] == s2["param_groups"], "optimizer param_groups differ")
    for i, st in s1["state"].items():
        for k, v in st.items():
            check(torch.equal(v, s2["state"][i][k]), f"optimizer state {i}/{k} differs")
    with torch.no_grad():
        check(torch.equal(model2(eval_tokens), logits), "logits differ after restore")
    check(meta2["step"] == 1, "meta step not restored")
    wq = snap.read_object("0/model/layer0.attn.wq.weight")  # a new tensor on cuda
    check(wq.is_cuda and torch.equal(wq, model.layer0.attn.wq.weight), "read_object differs")
    print(f"main path: state {nb} bytes; take {take_s:.3f} s ({nb / take_s / 1e9:.3f} GB/s), "
          f"restore {restore_s:.3f} s ({nb / restore_s / 1e9:.3f} GB/s)")
    print("restore members routed to the host path before launch: "
          f"{json.dumps(batcher.DEVICE_UNPACK_MISSES)}; K1 members made contiguous "
          f"first: {device_pack.COUNTS['made_contiguous']}; counters: "
          f"{json.dumps(tts.obs.counters())}")
    return model2


def host_digest_rate():
    """crc32 + adler32 over the same 256 MiB (the digests every staged
    byte pays during take), median of 3: zlib's two passes on one thread,
    the native one-pass ``tsnp_digest`` on one thread and on 4 threads at
    once (the staging threads; the GIL is released), and the native
    ``tsnp_copy_digest`` (the host slab pack).  Every result must equal
    zlib's."""
    import zlib
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from torchsnapshot_tpu_torch import _csrc

    lib = _csrc.load()
    buf = np.random.default_rng(0).integers(0, 256, 256 << 20, dtype=np.uint8)
    dst = np.empty_like(buf)
    want = (zlib.crc32(buf), zlib.adler32(buf))

    def median_s(fn):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = fn()
            times.append(time.perf_counter() - t0)
            check(got == want, f"host digest {got} != zlib's {want}")
        return sorted(times)[1]

    zlib_s = median_s(lambda: (zlib.crc32(buf), zlib.adler32(buf)))
    native_s = median_s(lambda: _csrc.digest(lib, buf))
    with ThreadPoolExecutor(4) as pool:
        def four():
            res = list(pool.map(lambda _: _csrc.digest(lib, buf), range(4)))
            check(all(r == want for r in res), "threaded native digest differs from zlib")
            return res[0]
        four_s = median_s(four)
    copy_s = median_s(lambda: _csrc.copy_digest(lib, dst, buf))
    check(bool((dst == buf).all()), "copy_digest copied the wrong bytes")
    gb = buf.nbytes / 1e9
    print(f"host digest rate (crc32 + adler32 of 256 MiB, median of 3, equal to zlib's): "
          f"zlib one thread {gb / zlib_s:.3f} GB/s; native tsnp_digest one thread "
          f"{gb / native_s:.3f} GB/s, 4 threads together {4 * gb / four_s:.3f} GB/s; "
          f"native tsnp_copy_digest one thread {gb / copy_s:.3f} GB/s; host cores: {os.cpu_count()}")


FASTIO_SETTINGS = {  # label → (FASTIO, FASTIO_DIRECT)
    "FASTIO=0": (False, False),
    "FASTIO=1": (True, False),
    "FASTIO=1+FASTIO_DIRECT=1": (True, True),
}
FASTIO_REPEATS = 3
FASTIO_COUNTERS = (
    "FASTIO_BYTES_WRITTEN", "FASTIO_BYTES_READ", "FASTIO_FUSED_DIGESTS", "FASTIO_POOL_WAITS",
    "FASTIO_DIRECT_PARTS", "FASTIO_BUFFERED_PARTS", "FASTIO_DONTNEED_READS",
)


# span totals (seconds summed over concurrent tasks) printed per run
FASTIO_TAKE_SPANS = ("pipeline/staging", "pipeline/slab_pack", "pipeline/io", "fastio/write_file")
FASTIO_RESTORE_SPANS = ("pipeline/io", "fastio/read_into", "pipeline/consume")


def span_delta(before, after, names):
    return json.dumps({n: round(after.get(n, 0.0) - before.get(n, 0.0), 4) for n in names})


def snapshot_digests(root):
    """The manifest's digests: each entry's crc32 and each stored object's
    [crc32, adler32, size]."""
    md = tts.Snapshot(root).metadata
    return {k: getattr(e, "crc32", None) for k, e in md.manifest.items()}, md.objects


def zero_state(model, opt):
    with torch.no_grad():
        for t in model.state_dict().values():
            t.zero_()
        for st in opt.state_dict()["state"].values():
            for v in st.values():
                if isinstance(v, torch.Tensor):
                    v.zero_()


def phase_fastio(cfg, model, opt, work):
    """The serving state taken and restored under FASTIO=0 (the fs
    plugin's pure-Python legs), FASTIO=1 (the engine, buffered) and
    FASTIO=1 + FASTIO_DIRECT=1, ``FASTIO_REPEATS`` times each in
    alternating order, each snapshot deleted after use.  Every restore
    lands in a zeroed model and optimizer and must equal the state
    bitwise; every snapshot's manifest digests must equal the first's."""
    from torchsnapshot_tpu_torch import _csrc, knobs
    from torchsnapshot_tpu_torch.storage.fs import FSStoragePlugin

    root = os.path.join(work, "fastio")
    os.makedirs(root)
    with knobs.override_fastio_direct(True):
        probe = FSStoragePlugin(root)
    check(probe._fastio is not None, "the fast-I/O engine did not load with the knobs at their defaults")
    direct = probe._fastio.direct
    probe.sync_close()
    print(f"fastio: library {_csrc.LOADED['path']} built from {_csrc.SOURCE}, g++ flags "
          f"'{_csrc.LOADED['flags']}'; O_DIRECT on the work directory {root}: "
          f"{'active' if direct else 'refused (buffered legs + posix_fadvise DONTNEED)'}")
    nb = state_bytes(model, opt)
    model2, opt2 = deterministic_state(cfg, 3)
    labels = list(FASTIO_SETTINGS)
    times = {label: {"take": [], "restore": []} for label in labels}
    counts = {label: dict.fromkeys(FASTIO_COUNTERS, 0) for label in labels}
    ref_digests = None
    for rep in range(FASTIO_REPEATS):
        for label in labels if rep % 2 == 0 else labels[::-1]:
            fio, fdirect = FASTIO_SETTINGS[label]
            snap_dir = os.path.join(root, f"rep{rep}")
            zero_state(model2, opt2)
            t0 = time.perf_counter()
            os.sync()  # no earlier run's dirty pages in this one's way
            sync_s = time.perf_counter() - t0
            before, spans0 = tts.obs.counters(), tts.obs.span_totals()
            with knobs.override_fastio(fio), knobs.override_fastio_direct(fdirect):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tts.Snapshot.take(snap_dir, {"model": model, "optim": opt})
                times[label]["take"].append(time.perf_counter() - t0)
                spans1 = tts.obs.span_totals()
                t0 = time.perf_counter()
                tts.Snapshot(snap_dir).restore({"model": model2, "optim": opt2})
                torch.cuda.synchronize()
                times[label]["restore"].append(time.perf_counter() - t0)
            after, spans2 = tts.obs.counters(), tts.obs.span_totals()
            print(f"fastio run {rep} {label}: take {times[label]['take'][-1]:.4f} s, span totals "
                  f"{span_delta(spans0, spans1, FASTIO_TAKE_SPANS)}; restore "
                  f"{times[label]['restore'][-1]:.4f} s, span totals "
                  f"{span_delta(spans1, spans2, FASTIO_RESTORE_SPANS)}; os.sync before it {sync_s:.3f} s")
            for c in FASTIO_COUNTERS:
                name = getattr(tts.obs, c)
                counts[label][c] += after.get(name, 0) - before.get(name, 0)
            differs = same_state((model, opt), (model2, opt2))
            check(differs is None, f"fastio {label} run {rep}: restored {differs} differs")
            digests = snapshot_digests(snap_dir)
            ref_digests = ref_digests or digests
            check(digests == ref_digests, f"fastio {label} run {rep}: manifest digests differ")
            shutil.rmtree(snap_dir)
    check(counts["FASTIO=0"]["FASTIO_BYTES_WRITTEN"] == 0, "FASTIO=0 went through the engine")
    check(counts["FASTIO=1"]["FASTIO_FUSED_DIGESTS"] > 0, "FASTIO=1 fused no digest into a write")
    check((counts["FASTIO=1+FASTIO_DIRECT=1"]["FASTIO_DIRECT_PARTS"] > 0) == direct,
          "FASTIO_DIRECT=1 did not take the direct legs the probe found")
    for label in labels:
        line = [f"fastio {label}: state {nb} bytes"]
        for op in ("take", "restore"):
            ts = sorted(times[label][op])
            med = ts[len(ts) // 2]
            line.append(f"{op} median {med:.4f} s [{ts[0]:.4f}-{ts[-1]:.4f}] "
                        f"({nb / med / 1e9:.3f} GB/s), runs {[round(t, 4) for t in times[label][op]]}")
        counters = {getattr(tts.obs, c): v for c, v in counts[label].items()}
        print("; ".join(line) + f"; counters over its runs {json.dumps(counters)}")
    print(f"fastio: {FASTIO_REPEATS} runs per setting in alternating order, every restore bitwise, "
          "every manifest's digests equal; a buffered restore reads the files its take wrote just "
          "before, from the page cache, so its seconds are not disk bandwidth")
    del model2, opt2


def phase_attention(cfg, model):
    q, k, v = restored_layer0_qkv(cfg, model)
    with torch.no_grad():
        out = ring_attention(q, k, v, causal=True)
        want = dense_attention(q.float(), k.float(), v.float(), causal=True)
    torch.cuda.synchronize()
    err = float((out.float() - want).abs().max())
    check(bool(torch.isfinite(out).all()) and out.shape == q.shape, "ring attention output malformed")
    check(err <= 2e-2, f"ring attention vs dense: max abs err {err} beyond 2e-2")
    print(f"ring attention on restored layer0 (s={SEQ}): max abs err vs f32 dense {err:.3e}")


def restored_layer0_qkv(cfg, model):
    g = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, cfg.vocab, (1, SEQ), device="cuda", generator=g)
    positions = torch.arange(SEQ, device="cuda").expand(tokens.shape)
    layer = model.layer0
    with torch.no_grad():
        return layer.attn.qkv(layer.norm1(model.embed(tokens)), positions)


def phase_ring_gradient(cfg, model):
    """The gradient of a loss through bf16 ring attention (K3 forward,
    K4/K5 backward) against f32 dense attention's autograd gradient."""
    q, k, v = (t.detach().requires_grad_() for t in restored_layer0_qkv(cfg, model))
    g = torch.Generator(device="cuda").manual_seed(12)
    ct = torch.randn(q.shape, device="cuda", generator=g)
    grads = torch.autograd.grad((ring_attention(q, k, v, causal=True).float() * ct).sum(), (q, k, v))
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad((dense_attention(qf, kf, vf, causal=True) * ct).sum(), (qf, kf, vf))
    torch.cuda.synchronize()
    errs = []
    for name, a, b in zip("qkv", grads, want):
        check(a is not None and a.dtype == q.dtype and bool(torch.isfinite(a).all()),
              f"ring gradient d{name} missing or malformed")
        rel = float((a.float() - b).abs().max()) / float(b.abs().max())
        check(rel <= 3e-2, f"ring gradient d{name}: error {rel} beyond 3e-2 of the largest gradient")
        errs.append(f"d{name} {rel:.3e}")
    print(f"ring-attention gradient on restored layer0 (s={SEQ}) vs f32 dense autograd, "
          f"max error / max |gradient|: {', '.join(errs)}")


def host_clone_state(model, opt):
    """The state on the host: a device clone would sit beside the next
    step in memory the step's peak did not count."""
    return (
        {k: v.to("cpu", copy=True) for k, v in model.state_dict().items()},
        {i: {k: v.to("cpu", copy=True) for k, v in st.items()} for i, st in opt.state_dict()["state"].items()},
    )


def step_peak(model, opt, tokens):
    """``train_step`` from an emptied allocator cache with the peaks reset:
    the step's own reserved footprint, fragmentation included, which the
    async take's device-copy budget reads."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    loss = train_step(model, opt, tokens)
    torch.cuda.synchronize()
    return loss, torch.cuda.max_memory_reserved()


def phase_resumable_training(cfg, root):
    """train_step at s = 2048 on a batch whose activations fill most of
    the card, async_take, the next train_step while the snapshot drains,
    restore into a differently seeded state, resume bitwise."""
    g = torch.Generator(device="cuda").manual_seed(21)
    batch = lambda n: torch.randint(0, cfg.vocab, (n, SEQ + 1), device="cuda", generator=g)  # noqa: E731
    model, opt = make_train_state(cfg, seed=0, device="cuda")
    train_step(model, opt, batch(1))  # AdamW's moments exist from here on
    nb = state_bytes(model, opt)
    # the step's peak at 4 and 8 sequences, where activations outweigh
    # the optimizer's temporaries, gives its footprint per sequence
    _, peak4 = step_peak(model, opt, batch(4))
    _, peak8 = step_peak(model, opt, batch(8))
    per_seq = (peak8 - peak4) // 4
    check(per_seq > 0, f"the step's peak does not grow with the batch ({peak4}, {peak8})")
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    capacity = free + torch.cuda.memory_reserved()
    # Aim the step's peak where half of the state's device copies fit
    # beside the next step, so both kinds of copy run: as many sequences
    # as fit under that peak, and a ballast tensor (memory the process
    # holds for something else) for the rest of the way, first short of
    # it by 2 GB, then corrected by what the linear estimate missed.
    target = capacity - int(total * host_offload.HEADROOM_FRACTION) - nb // 2
    n_seq = 8 + (target - peak8) // per_seq
    check(n_seq >= 8, f"the card holds too little for the training phase ({capacity} bytes)")
    batch_a, batch_b = batch(n_seq), batch(n_seq)
    ballast_bytes = max(0, target - peak8 - (n_seq - 8) * per_seq - 2 * 10**9)
    ballast = torch.empty(ballast_bytes, dtype=torch.uint8, device="cuda")
    _, first_peak = step_peak(model, opt, batch_a)
    ballast_bytes = max(0, ballast_bytes + target - first_peak)
    del ballast
    torch.cuda.empty_cache()  # the new ballast takes a segment of its own
    ballast = torch.empty(ballast_bytes, dtype=torch.uint8, device="cuda")
    # the allocator's high-water mark over two steps, as a loop that never
    # resets it keeps it: what the take's budget reads
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        train_step(model, opt, batch_a)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_reserved()
    print(f"resumable training: reserved step peaks {peak4} (4 sequences), {peak8} (8), {first_peak} "
          f"({n_seq}, short of the target), {peak} (two steps of {n_seq}, ballast {ballast_bytes}); "
          f"target {target}")
    params_at_take, opt_at_take = host_clone_state(model, opt)
    # what async_take's own budget will read
    budget = host_offload.device_copy_budget_bytes(torch.device("cuda", torch.cuda.current_device()))
    torch.cuda.synchronize()
    tts.obs.reset()
    t0 = time.perf_counter()
    pending = tts.Snapshot.async_take(
        root, {"model": model, "optim": opt, "rng": tts.RNGState(), "meta": tts.StateDict(step=1)}
    )
    unblock_s = time.perf_counter() - t0
    offload = dict(host_offload.LAST_OFFLOAD_STATS)
    torch.cuda.reset_peak_memory_stats()  # the next step's peaks, the copies' pool included
    loss_b = train_step(model, opt, batch_b)  # changes the state in place
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0 - unblock_s
    drained_during_step = pending.done()
    step_peak_with_copies = torch.cuda.max_memory_reserved()
    t1 = time.perf_counter()
    pending.wait()
    wait_s = time.perf_counter() - t1
    total_s = time.perf_counter() - t0
    print(f"async_take span totals (s, summed over concurrent tasks): {span_summary()}")
    del model, opt, ballast, pending
    gc.collect()
    live = sum(host_offload._LIVE_COPY_BYTES.values())
    check(live == 0, f"{live} bytes of device copies still live after wait()")
    torch.cuda.empty_cache()

    model2, opt2 = make_train_state(cfg, seed=1, device="cuda")
    train_step(model2, opt2, batch(1))
    meta2 = tts.StateDict(step=0)
    tts.Snapshot(root).restore({"model": model2, "optim": opt2, "rng": tts.RNGState(), "meta": meta2})
    for name, t in model2.state_dict().items():
        check(torch.equal(t.cpu(), params_at_take[name]), f"resumed tensor {name} differs from the clone")
    for i, st in opt2.state_dict()["state"].items():
        for k, v in st.items():
            check(torch.equal(v.cpu(), opt_at_take[i][k]), f"resumed optimizer state {i}/{k} differs")
    check(meta2["step"] == 1, "meta step not restored")
    loss_b2 = train_step(model2, opt2, batch_b)
    check(torch.equal(loss_b2, loss_b), f"resumed loss {float(loss_b2)!r} != {float(loss_b)!r}")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    train_step(model2, opt2, batch_b)  # the same step with no snapshot draining
    torch.cuda.synchronize()
    lone_step_s = time.perf_counter() - t1
    print(f"resumable training: batch {n_seq} x {SEQ} tokens; allocator capacity {capacity} bytes of "
          f"{total}; reserved step peak {peak} bytes ({per_seq} per sequence); "
          f"device-copy budget {budget} bytes; reserved peak of the next step beside the copies "
          f"{step_peak_with_copies} bytes")
    print(f"resumable training: state {nb} bytes; async_take unblocked in {unblock_s:.4f} s "
          f"(device copies {offload['device_copy_bytes']} bytes, host copies "
          f"{offload['host_copy_bytes']} bytes, blocking host copies {offload['blocking_host_bytes']} "
          f"bytes); next train_step {step_s:.4f} s beside the drain (snapshot done by then: "
          f"{drained_during_step}), the same step alone {lone_step_s:.4f} s; "
          f"wait() {wait_s:.3f} s; async_take to commit {total_s:.3f} s ({nb / total_s / 1e9:.3f} GB/s); "
          f"step loss {float(loss_b)!r} equal bitwise after restore")
    t0 = time.perf_counter()
    pinned = torch.empty(nb, dtype=torch.uint8, pin_memory=True)
    pin_alloc_s = time.perf_counter() - t0
    del pinned
    print(f"for comparison: allocating {nb} bytes of pinned host memory takes {pin_alloc_s:.3f} s")


def budgeted_read(snap, path, template, want, label):
    """One ``read_object`` with ``READ_BUDGET``; checks the result bitwise
    and prints its tiles, seconds, K6 launches, the pinned tile high-water
    mark and the rise in allocated device memory."""
    tiles0 = tts.obs.counters().get(tts.obs.TILES_READ, 0)
    k6_0 = device_pack.LAUNCHES["tile_update"]
    array_preparer.PINNED_TILES["high_water_bytes"] = 0
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = snap.read_object(path, obj_out=template, memory_budget_bytes=READ_BUDGET, device=want.device)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rise = torch.cuda.max_memory_allocated() - alloc0
    tiles = tts.obs.counters().get(tts.obs.TILES_READ, 0) - tiles0
    k6 = device_pack.LAUNCHES["tile_update"] - k6_0
    hw = array_preparer.PINNED_TILES["high_water_bytes"]
    check(template is None or out is template, f"{label}: the template was not filled in place")
    check(out.dtype == want.dtype and out.device == want.device and torch.equal(out, want),
          f"{label}: the result differs from the source")
    check(hw <= 2 * READ_BUDGET, f"{label}: {hw} bytes of pinned tiles beyond the budget and one tile")
    nb = want.numel() * want.element_size()
    print(f"budgeted read {label}: {tiles} tiles, {dt:.4f} s ({nb / dt / 1e9:.3f} GB/s of result), "
          f"K6 launches {k6}, pinned tile high water {hw} bytes (budget {READ_BUDGET}), "
          f"device memory rise {rise} bytes")
    return out, k6


def phase_budgeted_reads(model, work, snap_dir):
    """read_object of the embedding and the LM head with a 32 MiB budget
    out of the serving path's snapshot, and of the embedding chunked (64
    MiB chunks): into bf16 CUDA templates (identity: copies only), f32
    CUDA templates (K6), no template (a fresh CUDA tensor) and CPU
    templates; again under VERIFY_ON_RESTORE=1, plus a corrupted copy of
    the chunked snapshot that must raise, leaving the template usable."""
    chunked_dir = os.path.join(work, "chunked")
    with tts.knobs.override_max_chunk_size_bytes(64 << 20):
        tts.Snapshot.take(chunked_dir, {"emb": tts.StateDict(embed=model.embed.weight.detach())})
    snap, chunked = tts.Snapshot(snap_dir), tts.Snapshot(chunked_dir)
    check(type(chunked.metadata.manifest["0/emb/embed"]).__name__ == "ChunkedArrayEntry",
          "the chunked snapshot's embedding is not chunked")
    sources = (
        ("embedding", snap, "0/model/embed.weight", model.embed.weight.detach()),
        ("LM head", snap, "0/model/lm_head.weight", model.lm_head.weight.detach()),
        ("chunked embedding", chunked, "0/emb/embed", model.embed.weight.detach()),
    )
    for name, sn, path, src in sources:
        budgeted_read(sn, path, torch.empty_like(src), src, f"{name} -> bf16 CUDA template")
        _, k6 = budgeted_read(sn, path, torch.empty(src.shape, device="cuda"), src.float(),
                              f"{name} -> f32 CUDA template")
        check(k6 > 0, f"{name}: the read into an f32 template launched no K6")
        budgeted_read(sn, path, None, src, f"{name} -> no template (fresh CUDA tensor)")
        budgeted_read(sn, path, torch.empty(src.shape, dtype=src.dtype), src.cpu(), f"{name} -> CPU template")
    src = model.embed.weight.detach()
    f32 = torch.empty(src.shape, device="cuda")
    with tts.knobs.override_verify_on_restore(True):
        for name, sn, path in (("embedding", snap, "0/model/embed.weight"),
                               ("chunked embedding", chunked, "0/emb/embed")):
            budgeted_read(sn, path, f32, src.float(), f"{name} -> f32 CUDA template, VERIFY_ON_RESTORE=1")
        budgeted_read(chunked, "0/emb/embed", None, src, "chunked embedding -> no template, VERIFY_ON_RESTORE=1")
        corrupt_dir = os.path.join(work, "corrupt")
        shutil.copytree(chunked_dir, corrupt_dir)
        victim = max((os.path.join(r, f) for r, _, fs in os.walk(corrupt_dir) for f in fs
                      if f != ".snapshot_metadata"), key=os.path.getsize)
        with open(victim, "r+b") as f:
            f.seek(os.path.getsize(victim) // 2)
            b = f.read(1)
            f.seek(os.path.getsize(victim) // 2)
            f.write(bytes([b[0] ^ 0x40]))
        try:
            tts.Snapshot(corrupt_dir).read_object("0/emb/embed", obj_out=f32, memory_budget_bytes=READ_BUDGET)
        except RuntimeError as e:
            check("crc32" in str(e), f"the corrupted read raised something else: {e}")
            print(f"budgeted read of a corrupted copy ({os.path.basename(victim)}, one byte flipped) "
                  f"raised: {str(e)[:160]}")
        else:
            raise RuntimeError("check failed: a corrupted payload read back under VERIFY_ON_RESTORE=1")
        budgeted_read(chunked, "0/emb/embed", f32, src.float(),
                      "chunked embedding -> the same f32 template after the failed read")
    print(f"budgeted reads: TILE_MISSES {json.dumps(array_preparer.TILE_MISSES)}")
    shutil.rmtree(chunked_dir)
    shutil.rmtree(corrupt_dir)


def deterministic_state(cfg, seed):
    """The full-width model from ``seed`` and its AdamW after one step on
    gradients drawn from ``seed`` (elementwise work only, so every
    process builds the same bits)."""
    model, opt = make_train_state(cfg, seed=seed, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed + 100)
    for p in model.parameters():
        p.grad = (torch.randn(p.shape, device="cuda", generator=g) * 1e-3).to(p.dtype)
    opt.step()
    opt.zero_grad(set_to_none=True)
    return model, opt


def same_state(a, b):
    (m1, o1), (m2, o2) = a, b
    for (name, x), y in zip(m1.state_dict().items(), m2.state_dict().values()):
        if not (x.dtype == y.dtype and torch.equal(x, y)):
            return f"model tensor {name}"
    s1, s2 = o1.state_dict(), o2.state_dict()
    for i, st in s1["state"].items():
        for k, v in st.items():
            if not torch.equal(v, s2["state"][i][k]):
                return f"optimizer state {i}/{k}"
    return None


def many_ranks_child(rank, world, port, root):
    """One rank of the many_ranks path (see ``phase_many_ranks``); prints
    one ``many_ranks result`` JSON line and exits non-zero on a failure."""
    import torch.distributed as dist

    from torchsnapshot_tpu_torch.resilience.abort import SnapshotAbortedError

    if not torch.cuda.is_available():
        print("many_ranks child: no CUDA device", file=sys.stderr)
        return 2
    # gloo is initialized only for its TCPStore, which the snapshots'
    # coordinator uses; no collective runs
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
    coord = tts.get_default_coordinator()
    check(isinstance(coord, tts.TorchStoreCoordinator), f"default coordinator is {type(coord).__name__}")
    cfg = TransformerConfig(n_layers=N_LAYERS)
    model, opt = deterministic_state(cfg, seed=0)
    mine = tts.StateDict(t=torch.full((1 << 20,), float(rank), device="cuda"), rank=rank)
    rng = tts.RNGState()
    rng_at_take = rng.state_dict()
    app = {"model": tts.Replicated(model), "optim": tts.Replicated(opt), "mine": mine, "rng": rng}
    repl_bytes = state_bytes(model, opt)
    for table in (device_pack.LAUNCHES,):
        for k in table:
            table[k] = 0
    out = {"rank": rank, "replicated_bytes": repl_bytes}

    def written():
        return tts.obs.counters().get(tts.obs.BYTES_WRITTEN, 0)

    sync_dir, async_dir, fail_dir = (os.path.join(root, n) for n in ("sync", "async", "failed"))
    torch.cuda.synchronize()
    w0, t0 = written(), time.perf_counter()
    tts.Snapshot.take(sync_dir, app)
    out["take_s"], out["take_bytes"] = time.perf_counter() - t0, written() - w0
    share = out["take_bytes"] / repl_bytes
    check(0.4 <= share <= 0.6, f"rank {rank} wrote {share:.3f} of the replicated bytes")

    model2, opt2 = deterministic_state(cfg, seed=1)
    mine2 = tts.StateDict(t=torch.zeros(1 << 20, device="cuda"), rank=-1)
    torch.manual_seed(1234)  # moves the RNG streams off their state at the take
    t0 = time.perf_counter()
    tts.Snapshot(sync_dir).restore(
        {"model": tts.Replicated(model2), "optim": tts.Replicated(opt2), "mine": mine2, "rng": rng}
    )
    torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t0
    diff = same_state((model, opt), (model2, opt2))
    check(diff is None, f"rank {rank}: restored {diff} differs")
    check(torch.equal(mine2["t"], mine["t"]) and mine2["rank"] == rank, f"rank {rank}: per-rank state differs")
    check(torch.equal(rng.state_dict()["torch"], rng_at_take["torch"]), f"rank {rank}: RNG state not restored")
    del model2, opt2

    t0 = time.perf_counter()
    pending = tts.Snapshot.async_take(async_dir, app)
    out["async_unblock_s"] = time.perf_counter() - t0
    pending.wait()
    out["async_commit_s"] = time.perf_counter() - t0
    coord.barrier()
    check(os.path.exists(os.path.join(async_dir, ".snapshot_metadata")), "async take left no metadata")

    import torchsnapshot_tpu_torch.snapshot as snapmod
    from torchsnapshot_tpu_torch.storage.fs import FSStoragePlugin

    class FailingWrites(FSStoragePlugin):
        async def write(self, write_io):
            raise OSError(f"rank {rank}: injected storage failure")

    real = snapmod.url_to_storage_plugin
    if rank == 1:
        snapmod.url_to_storage_plugin = lambda p: FailingWrites(root=p)
    t0 = time.perf_counter()
    try:
        tts.Snapshot.take(fail_dir, app)
    except SnapshotAbortedError as e:
        out["failure"] = f"SnapshotAbortedError: {str(e)[:120]}"
        check(rank != 1, "the failing rank raised an abort, not its own error")
    except OSError as e:
        out["failure"] = f"OSError: {e}"
        check(rank == 1, f"rank {rank} raised the injected error")
    else:
        raise RuntimeError(f"check failed: rank {rank}'s take did not fail")
    finally:
        snapmod.url_to_storage_plugin = real
    out["failure_s"] = time.perf_counter() - t0
    check(out["failure_s"] < 10, f"rank {rank} took {out['failure_s']:.1f} s to raise")
    coord.barrier()  # outside the abort scope: both ranks are done
    check(not os.path.exists(os.path.join(fail_dir, ".snapshot_metadata")), "a failed take wrote metadata")
    out["launches"] = dict(device_pack.LAUNCHES)
    print("many_ranks result " + json.dumps(out), flush=True)
    dist.destroy_process_group()
    return 0


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


SHARD_BOX_BYTES = 64 << 20  # MAX_SHARD_SIZE_BYTES on the sharded path


def spawn_ranks(flag, root, world=2, timeout_s=300):
    """Start this script ``world`` times as ``flag <rank> <world> <port>
    <root>``; returns each child's JSON result (the line starting with
    ``flag``'s word and ``result``), in rank order.  A child that exits
    non-zero fails the path."""
    port = free_port()
    tag = f"{flag.strip('-').replace('-child', '').replace('-', '_')} result "
    # each child writes to a file: a pipe the parent is not reading could
    # fill and stall a child while its peer waits for it
    logs = [open(os.path.join(root, f"{flag.strip('-')}{r}.log"), "w+") for r in range(world)]
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag, str(r), str(world), str(port), root],
            stdout=logs[r], stderr=subprocess.STDOUT, text=True,
        )
        for r in range(world)
    ]
    try:
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, f) in enumerate(zip(procs, logs)):
        f.seek(0)
        text = f.read()
        f.close()
        for line in text.splitlines():
            if line.startswith(tag):
                results.append(json.loads(line[len(tag):]))
        if p.returncode != 0:
            print(text[-4000:])
            raise RuntimeError(f"check failed: {flag} rank {r} exited {p.returncode}")
    check(len(results) == world, f"a {flag} child printed no result")
    return sorted(results, key=lambda x: x["rank"])


def phase_many_ranks(cfg, work):
    """Two processes on the one card, coordinated over a TCPStore on
    localhost: sync take at world 2 of a replicated model and optimizer
    plus per-rank state (each rank writes 40-60% of the replicated bytes),
    restore at world 2, async_take with its commit barrier, and a take in
    which rank 1's storage fails (both raise within 10 s, rank 0 a
    SnapshotAbortedError, no metadata); then a restore at world 1 here,
    bitwise for the replicated state.  Returns the children's launches."""
    root = os.path.join(work, "many_ranks")
    os.makedirs(root)
    results = spawn_ranks("--many-ranks-child", root)
    for res in results:
        print(f"many_ranks rank {res['rank']}: take {res['take_s']:.3f} s writing {res['take_bytes']} bytes "
              f"({res['take_bytes'] / res['replicated_bytes']:.3f} of the {res['replicated_bytes']} replicated "
              f"bytes); restore at world 2 {res['restore_s']:.3f} s; async_take unblocked in "
              f"{res['async_unblock_s']:.4f} s, committed in {res['async_commit_s']:.3f} s; failed take raised "
              f"after {res['failure_s']:.3f} s: {res['failure']}")
    model, opt = deterministic_state(cfg, seed=0)
    model2, opt2 = deterministic_state(cfg, seed=1)
    mine = tts.StateDict(t=torch.full((1 << 20,), -1.0, device="cuda"), rank=-1)
    t0 = time.perf_counter()
    tts.Snapshot(os.path.join(root, "sync")).restore(
        {"model": tts.Replicated(model2), "optim": tts.Replicated(opt2), "mine": mine}
    )
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    diff = same_state((model, opt), (model2, opt2))
    check(diff is None, f"world-1 restore: {diff} differs")
    check(mine["rank"] == 0 and bool((mine["t"] == 0).all()), "world-1 restore: rank 0's per-rank state differs")
    print(f"many_ranks: restore at world 1 of the world-2 snapshot {restore_s:.3f} s, bitwise")
    del model, opt, model2, opt2
    shutil.rmtree(root)
    launches = {}
    for res in results:
        for k, v in res["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return launches


def full_state(model, opt):
    """``"model/<name>"`` and ``"optim/<i>/<key>"`` → the tensors of a
    plain (unsharded) model and its optimizer: the reference a sharded
    restore is held against."""
    out = {f"model/{n}": p.detach() for n, p in model.named_parameters()}
    for i, st in opt.state_dict()["state"].items():
        out.update({f"optim/{i}/{k}": v for k, v in st.items()})
    return out


def local_of(full, dt):
    """The part of ``full`` that DTensor ``dt``'s local tensor holds."""
    from torchsnapshot_tpu_torch.preparers.sharded import box_at

    mesh = dt.device_mesh
    offsets, sizes = box_at(full.shape, mesh.shape, mesh.get_coordinate(), dt.placements)
    return full[tuple(slice(o, o + n) for o, n in zip(offsets, sizes))]


def check_restored(ref, params, opt_state, label):
    """Every restored parameter (name → tensor or DTensor) and optimizer
    state (index → key → tensor) bitwise equal to ``ref`` cast to its
    dtype (a DTensor's local tensor to its box of ``ref``)."""
    items = [(f"model/{n}", t) for n, t in params.items()]
    items += [(f"optim/{i}/{k}", t) for i, st in opt_state.items() for k, t in st.items()]
    check(len(items) == len(ref), f"{label}: {len(items)} tensors restored, {len(ref)} taken")
    for key, t in items:
        got, want = (t.to_local(), local_of(ref[key], t)) if hasattr(t, "device_mesh") else (t, ref[key])
        check(torch.equal(got, want.to(got.device, got.dtype)), f"{label}: {key} differs")


def sharded_templates(model, opt, mesh, place=list, dtype=None):
    """Zero DTensor templates of ``model``'s parameters and ``opt``'s state,
    each moment laid out as ``place(placements)`` of its parameter, in
    ``dtype`` (the state's own by default): ``model`` and ``optim`` app
    state for a restore."""
    from torchsnapshot_tpu_torch.parallel.mesh import distribute

    def zeros(t):
        return distribute(
            torch.zeros(t.shape, dtype=dtype or t.dtype, device="cuda"), mesh, place(t.placements)
        )

    sd = opt.state_dict()
    state = {
        i: {k: v.clone() if k == "step" else zeros(p) for k, v in sd["state"][i].items()}
        for i, p in enumerate(model.parameters())
    }
    model_t = tts.StateDict({n: zeros(p) for n, p in model.named_parameters()})
    return model_t, tts.StateDict(state=state, param_groups=sd["param_groups"])


def swapped(placements):
    """The transposed layout: Shard(0) ↔ Shard(1)."""
    from torch.distributed.tensor import Shard

    return [Shard(1 - p.dim) if p.is_shard() else p for p in placements]


def sharded_bytes(ref):
    return sum(nbytes(t) for k, t in ref.items() if not k.endswith("/step"))


def sharded_child(rank, world, port, root):
    """One rank of the sharded path's part 2 (see ``phase_sharded``);
    prints one ``sharded result`` JSON line, exits non-zero on a
    failure."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from torchsnapshot_tpu_torch.parallel.mesh import shard_train_state

    if not torch.cuda.is_available():
        print("sharded child: no CUDA device", file=sys.stderr)
        return 2
    # gloo: its TCPStore is the snapshots' coordinator; the take and the
    # restore run no collective of the mesh
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
    coord = tts.get_default_coordinator()
    out = {"rank": rank}
    mesh = DeviceMesh("cuda", list(range(world)), mesh_dim_names=("tp",))
    out["mesh"] = mesh.device_type
    cfg = TransformerConfig(n_layers=N_LAYERS)
    ref = full_state(*deterministic_state(cfg, seed=0))
    model, opt = shard_train_state(*deterministic_state(cfg, seed=0), mesh)
    for k in device_pack.LAUNCHES:
        device_pack.LAUNCHES[k] = 0
    misses = dict(array_preparer.TILE_MISSES)
    written = tts.obs.counters().get(tts.obs.BYTES_WRITTEN, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tts.knobs.override_max_shard_size_bytes(SHARD_BOX_BYTES):
        tts.Snapshot.take(os.path.join(root, "world2"), {"model": model, "optim": opt}, coordinator=coord)
    out["take_s"] = time.perf_counter() - t0
    out["take_bytes"] = tts.obs.counters().get(tts.obs.BYTES_WRITTEN, 0) - written
    out["sharded_bytes"] = sharded_bytes(ref)
    share = out["take_bytes"] / out["sharded_bytes"]
    check(0.4 <= share <= 0.6, f"rank {rank} wrote {share:.3f} of the state's bytes")

    model_t, optim_t = sharded_templates(model, opt, mesh, place=swapped)
    del model, opt
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tts.Snapshot(os.path.join(root, "world2"), coordinator=coord).restore(
        {"model": model_t, "optim": optim_t}
    )
    torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t0
    check_restored(ref, model_t, optim_t["state"], f"rank {rank} restore into the transposed layout")
    check(dict(array_preparer.TILE_MISSES) == misses, f"rank {rank}: a box missed the device path")
    out["launches"] = dict(device_pack.LAUNCHES)
    check(out["launches"]["slab_pack"] > 0, f"rank {rank}: the take at world 2 launched no K1")
    print("sharded result " + json.dumps(out), flush=True)
    coord.barrier()  # both ranks are done with the snapshot
    dist.destroy_process_group()
    return 0


def phase_sharded(cfg, work):
    """DTensor state at full width.  Part 1, in this process on a 1-rank
    CUDA mesh of shape (1, 1) named ("dp", "tp"): the model and AdamW
    laid out by ``parallel/mesh.py``'s rules, boxes subdivided at
    ``SHARD_BOX_BYTES``; sync take, async_take and ``wait()``, restores
    into bf16 DTensors (a fresh sharded model and optimizer), f32 DTensors
    (K6) and plain CUDA tensors, and a budgeted ``read_object`` of the
    embedding, all bitwise.  Part 2, two processes on the card over gloo,
    DTensors on a "tp" mesh of 2: a take at world 2 and a restore at
    world 2 into the transposed layout; then, here, the restore at world
    1 of that snapshot onto the 1-rank mesh and into plain tensors.
    Returns the children's launches."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from torchsnapshot_tpu_torch.parallel.mesh import shard_train_state

    root = os.path.join(work, "sharded")
    os.makedirs(root)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0, world_size=1)
    try:
        mesh = DeviceMesh("cuda", [[0]], mesh_dim_names=("dp", "tp"))
        ref = full_state(*deterministic_state(cfg, seed=0))
        model, opt = shard_train_state(*deterministic_state(cfg, seed=0), mesh)
        nb = sharded_bytes(ref)
        misses = dict(array_preparer.TILE_MISSES)
        sync_dir, async_dir = os.path.join(root, "sync"), os.path.join(root, "async")
        with tts.knobs.override_max_shard_size_bytes(SHARD_BOX_BYTES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            snap = tts.Snapshot.take(sync_dir, {"model": model, "optim": opt})
            take_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            pending = tts.Snapshot.async_take(async_dir, {"model": model, "optim": opt})
            unblock_s = time.perf_counter() - t0
            pending.wait()
            wait_s = time.perf_counter() - t0
        entry = snap.metadata.manifest["0/model/embed.weight"]
        check(len(entry.shards) == 4 and entry.spec == [None, "tp"] and entry.mesh_shape == [1, 1],
              f"the embedding's entry: {len(entry.shards)} boxes, spec {entry.spec}, mesh {entry.mesh_shape}")
        print(f"sharded: state {nb} bytes in DTensors on a (1, 1) cuda mesh; take {take_s:.3f} s "
              f"({nb / take_s / 1e9:.3f} GB/s); async_take unblocked in {unblock_s:.4f} s, wait() returned "
              f"{wait_s:.3f} s after the call; the embedding in {len(entry.shards)} boxes of "
              f"{SHARD_BOX_BYTES} bytes at most")
        del model, opt

        m2, o2 = shard_train_state(*deterministic_state(cfg, seed=1), mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tts.Snapshot(sync_dir).restore({"model": m2, "optim": o2})
        torch.cuda.synchronize()
        bf16_s = time.perf_counter() - t0
        check_restored(ref, dict(m2.named_parameters()), o2.state_dict()["state"], "restore into bf16 DTensors")
        model_t, optim_t = sharded_templates(m2, o2, mesh, dtype=torch.float32)
        del m2, o2
        k6 = device_pack.LAUNCHES["tile_update"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tts.Snapshot(async_dir).restore({"model": model_t, "optim": optim_t})
        torch.cuda.synchronize()
        f32_s = time.perf_counter() - t0
        k6 = device_pack.LAUNCHES["tile_update"] - k6
        check(k6 > 0, "the f32 restore launched no K6")
        check_restored(ref, model_t, optim_t["state"], "restore of the async snapshot into f32 DTensors")
        del model_t, optim_t
        plain_m, plain_o = deterministic_state(cfg, seed=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tts.Snapshot(sync_dir).restore({"model": plain_m, "optim": plain_o})
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        check_restored(ref, dict(plain_m.named_parameters()), plain_o.state_dict()["state"],
                       "restore into plain CUDA tensors")
        del plain_m, plain_o
        tiles0 = tts.obs.counters().get(tts.obs.TILES_READ, 0)
        array_preparer.PINNED_TILES["high_water_bytes"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emb = snap.read_object("0/model/embed.weight", memory_budget_bytes=READ_BUDGET)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        tiles = tts.obs.counters().get(tts.obs.TILES_READ, 0) - tiles0
        hw = array_preparer.PINNED_TILES["high_water_bytes"]
        check(emb.is_cuda and torch.equal(emb, ref["model/embed.weight"]), "budgeted read of the embedding differs")
        # its boxes split by rows, so its tiles land in place
        check(0 < hw <= 2 * READ_BUDGET, f"the sharded budgeted read held {hw} bytes of pinned tiles")
        print(f"sharded: restore into bf16 DTensors {bf16_s:.3f} s, into f32 DTensors {f32_s:.3f} s "
              f"({k6} K6 launches), into plain CUDA tensors {plain_s:.3f} s, all bitwise; budgeted read of "
              f"the embedding ({nbytes(emb)} bytes, budget {READ_BUDGET}): {tiles} row tiles, {read_s:.4f} s, "
              f"pinned tile high water {hw} bytes (row tiles landed in place)")
        del emb
        check(dict(array_preparer.TILE_MISSES) == misses, f"a box missed the device path: {array_preparer.TILE_MISSES}")
        gc.collect()
        torch.cuda.empty_cache()

        results = spawn_ranks("--sharded-child", root)
        for res in results:
            check(res["mesh"] == "cuda", f"sharded rank {res['rank']} ran on a {res['mesh']} mesh")
            print(f"sharded rank {res['rank']} (DTensors on a {res['mesh']} mesh): take at world 2 "
                  f"{res['take_s']:.3f} s writing {res['take_bytes']} bytes ({res['take_bytes'] / res['sharded_bytes']:.3f} "
                  f"of the {res['sharded_bytes']} bytes of DTensor state); restore at world 2 into the "
                  f"transposed layout {res['restore_s']:.3f} s, bitwise")
        world2 = os.path.join(root, "world2")
        m3, o3 = shard_train_state(*deterministic_state(cfg, seed=1), mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tts.Snapshot(world2).restore({"model": m3, "optim": o3})
        torch.cuda.synchronize()
        w1_s = time.perf_counter() - t0
        check_restored(ref, dict(m3.named_parameters()), o3.state_dict()["state"], "world-1 restore onto the mesh")
        del m3, o3
        plain_m, plain_o = deterministic_state(cfg, seed=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tts.Snapshot(world2).restore({"model": plain_m, "optim": plain_o})
        torch.cuda.synchronize()
        w1_plain_s = time.perf_counter() - t0
        check_restored(ref, dict(plain_m.named_parameters()), plain_o.state_dict()["state"],
                       "world-1 restore into plain tensors")
        print(f"sharded: restore at world 1 of the world-2 snapshot onto the (1, 1) mesh {w1_s:.3f} s, "
              f"into plain CUDA tensors {w1_plain_s:.3f} s, bitwise")
        del plain_m, plain_o, ref
    finally:
        dist.destroy_process_group()
    shutil.rmtree(root)
    launches = {}
    for res in results:
        for k, v in res["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    kernels.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    # the fast-I/O engine with the knobs at their defaults: a library that
    # does not build raises here
    from torchsnapshot_tpu_torch import _csrc

    t0 = time.perf_counter()
    check(_csrc.enabled_lib() is not None and tts.knobs.fastio_enabled(),
          "the native fast-I/O library is off at the knobs' defaults")
    print(f"native fast-I/O library: {_csrc.LOADED['path']} (g++ flags '{_csrc.LOADED['flags']}'), "
          f"built or loaded in {time.perf_counter() - t0:.1f} s")
    for name, log in kernels.BUILD_LOG.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "warning", "C75")):
                print(f"ptxas {name}: {line.strip()}")
        # the Hopper kernels' design rests on neither: a spill or a
        # serialised wgmma (C75xx) is a build that must be looked at
        check("(C75" not in log, f"ptxas serialised wgmma in {name}")
        check(all(" 0 bytes spill stores" in line for line in log.splitlines() if "spill stores" in line),
              f"ptxas spilled registers in {name}")

    cfg = TransformerConfig(n_layers=N_LAYERS)
    torch.manual_seed(0)
    model = TransformerLM(cfg, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params} parameters, {cfg}")

    members = first_device_slab(model)
    slab, mis_members, mis_slab, k1 = phase_k1(members)
    k2 = phase_k2(slab, members, mis_slab, mis_members)
    k6 = phase_k6(cfg)
    k3 = phase_k3()
    k4, k5 = phase_k4_k5()
    del slab, members, mis_members, mis_slab
    torch.cuda.empty_cache()
    records = {r["name"]: r for r in (k1, k2, k3, k4, k5, k6)}
    counters = {
        "slab_pack": (device_pack.LAUNCHES, "slab_pack"),
        "slab_unpack": (device_pack.LAUNCHES, "slab_unpack"),
        "flash_attention_fwd": (flash_attention.LAUNCHES, "flash_fwd"),
        "flash_attention_bwd_dq": (flash_attention.LAUNCHES, "flash_bwd_dq"),
        "flash_attention_bwd_dkv": (flash_attention.LAUNCHES, "flash_bwd_dkv"),
        "tile_update": (device_pack.LAUNCHES, "tile_update"),
    }

    def run_path(name, kernels_expected, fn):
        """``fn`` may return launches made in processes it started, by
        kernel name as their ``LAUNCHES`` tables count them."""
        for table, key in counters.values():
            table[key] = 0
        t_path = time.perf_counter()
        others = fn() or {}
        torch.cuda.synchronize()
        counts = {n: table[key] + others.get(key, 0) for n, (table, key) in counters.items()}
        print(f"path {name}: launches {json.dumps(counts)}; {time.perf_counter() - t_path:.1f} s")
        for n in kernels_expected:
            check(counts[n] > 0, f"{n} was not launched on the {name} path")
        for n, c in counts.items():
            records[n]["launches"] += c

    tokens = torch.randint(0, cfg.vocab, (1, 129), device="cuda")
    opt = adamw_step(model, tokens)
    restored = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        snap_dir = os.path.join(work, "snap")

        def serving():
            restored["model"] = phase_main_path(cfg, model, opt, snap_dir)
            phase_attention(cfg, restored["model"])

        run_path("serving", ("slab_pack", "slab_unpack", "flash_attention_fwd"), serving)
        run_path("fastio", ("slab_pack", "slab_unpack"), lambda: phase_fastio(cfg, model, opt, work))
        gc.collect()
        torch.cuda.empty_cache()
        run_path("ring_gradient", ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"),
                 lambda: phase_ring_gradient(cfg, restored["model"]))
        run_path("budgeted_reads", ("tile_update",), lambda: phase_budgeted_reads(model, work, snap_dir))
        shutil.rmtree(snap_dir)
        del model, opt, restored
        gc.collect()
        torch.cuda.empty_cache()

        peak_before_training = torch.cuda.max_memory_allocated()
        run_path("resumable_training", ("slab_pack", "slab_unpack"),
                 lambda: phase_resumable_training(cfg, os.path.join(work, "train")))
        host_digest_rate()
        print(f"peak device memory allocated: {peak_before_training} bytes before the training phase, "
              f"{torch.cuda.max_memory_allocated()} bytes in its last step")
        gc.collect()
        torch.cuda.empty_cache()
        run_path("many_ranks", ("slab_pack", "slab_unpack"), lambda: phase_many_ranks(cfg, work))
        gc.collect()
        torch.cuda.empty_cache()
        run_path("sharded", ("slab_pack", "tile_update"), lambda: phase_sharded(cfg, work))

    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 6 and sys.argv[1] == "--many-ranks-child":
        sys.exit(many_ranks_child(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]))
    if len(sys.argv) == 6 and sys.argv[1] == "--sharded-child":
        sys.exit(sharded_child(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]))
    sys.exit(main())
