#!/usr/bin/env python3
"""Drive the PyTorch port end to end on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (the kernels are built from ``csrc/`` on
first use) and a writable temporary directory (the snapshot is written
under ``$TMPDIR``).  It exits non-zero, printing no result, when there
is no card or anything below fails.  In order:

1. prints the card (``nvidia-smi`` name and power limit);
2. builds the CUDA kernels (K1 slab pack, K2 slab unpack, K3 flash-
   attention forward) and prints what ptxas reports for them;
3. kernel phase: holds each kernel against its plain PyTorch version on
   the card at the main path's shapes and times both, plus one PyTorch
   library call computing the same function where there is one.
   Tolerances: K1 and K2 bitwise; K3 m atol 1e-3 and pv/l normalised
   within 2e-2 (bf16 operands, another summation order);
4. main path at full width: the repo's transformer (TransformerConfig
   defaults, depth cut to 2 layers, bf16, ~0.67 B parameters) takes one
   AdamW step, is snapshotted with ``Snapshot.take``, restored into a
   differently seeded model and optimizer, and checked bitwise (every
   tensor, the logits on a fixed batch, the step counter,
   ``read_object``);
5. runs ring attention (ring size 1, so K3) on q/k/v projected from the
   restored layer-0 weights at s = 2048 and compares it with dense
   attention computed in f32 (tolerance 2e-2).

Launch counters are zeroed right before phase 4 and read right after
phase 5: every kernel must have launched during the main path.  The
line before the last is the card; the line before it the ``kernels``
JSON; the last line ``{"ok": true, "device": ...}``.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import torch

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import batcher
from torchsnapshot_tpu_torch.batcher import BatchedBufferStager, batch_write_requests
from torchsnapshot_tpu_torch.flatten import flatten
from torchsnapshot_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from torchsnapshot_tpu_torch.ops import device_pack, flash_attention, kernels
from torchsnapshot_tpu_torch.parallel.ring_attention import dense_attention, ring_attention
from torchsnapshot_tpu_torch.preparers import prepare_write
from torchsnapshot_tpu_torch.serialization import dtype_to_string

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bandwidth, bf16 tensor rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
N_LAYERS = 2
SEQ = 2048


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


def phase_k1(members):
    total = sum(nbytes(t) for t in members)
    got = device_pack.pack_slab(members)
    want = device_pack.pack_slab_plain(members)
    check(torch.equal(got, want), "K1 slab differs from its plain version")
    err = float((got.int() - want.int()).abs().max()) if total else 0.0
    views = [t.reshape(-1).view(torch.uint8) for t in members]
    ms = time_ms(lambda: device_pack.pack_slab(members))
    plain_ms = time_ms(lambda: device_pack.pack_slab_plain(members))
    library_ms = time_ms(lambda: torch.cat(views))
    host = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    d2h_ms = time_ms(lambda: host.copy_(got, non_blocking=True), iters=5)
    print(f"K1 slab: {len(members)} members, {total} bytes; pinned D2H of the slab "
          f"{d2h_ms:.3f} ms ({total / d2h_ms / 1e6:.2f} GB/s)")
    return got, kernel_record(
        "slab_pack", "torchsnapshot_tpu_torch/csrc/slab_pack.cu",
        "torchsnapshot_tpu/ops/device_pack.py:23", err, ms, plain_ms,
        2 * total / HBM_BYTES_PER_S * 1e3, "bytes", library_ms,
    )


def phase_k2(slab, members):
    """Unpack the K1 slab plus a bool member, casting member 0 bf16 → f32."""
    g = torch.Generator(device="cuda").manual_seed(2)
    flags = torch.rand(4099, device="cuda", generator=g) > 0.5
    slab = torch.cat([slab, flags.view(torch.uint8)])
    layout, off = [], 0
    for t in members + [flags]:
        layout.append((off, dtype_to_string(t.dtype), tuple(t.shape)))
        off += nbytes(t)
    out_dtypes = [torch.float32] + [t.dtype for t in members[1:]] + [torch.bool]
    outs = [torch.empty(t.shape, dtype=d, device="cuda") for t, d in zip(members + [flags], out_dtypes)]
    device_pack.unpack_slab_into(slab, layout, outs)
    want = device_pack.unpack_slab_plain(slab, layout, out_dtypes)
    err = 0.0
    for o, w in zip(outs, want):
        check(o.dtype == w.dtype and torch.equal(o, w), "K2 output differs from its plain version")
    out_bytes = sum(nbytes(o) for o in outs)
    ms = time_ms(lambda: device_pack.unpack_slab_into(slab, layout, outs))

    def plain_into():
        # the plain version plus the copy into the templates the kernel
        # writes (identity members decode to views of the slab)
        for o, w in zip(outs, device_pack.unpack_slab_plain(slab, layout, out_dtypes)):
            o.copy_(w)

    plain_ms = time_ms(plain_into)
    return kernel_record(
        "slab_unpack", "torchsnapshot_tpu_torch/csrc/slab_unpack.cu",
        "torchsnapshot_tpu/ops/device_pack.py:85", err, ms, plain_ms,
        (nbytes(slab) + out_bytes) / HBM_BYTES_PER_S * 1e3, "bytes", None,
    )


def compare_partials(got, want, what):
    pv, m, l = got
    wpv, wm, wl = want
    finite = torch.isfinite(wm)
    check(torch.equal(torch.isfinite(m), finite), f"{what}: masked rows differ")
    check(bool(((m - wm).abs()[finite] <= 1e-3).all()), f"{what}: m beyond atol 1e-3")
    denom = lambda x: torch.where(x == 0, 1.0, x)[..., None]  # noqa: E731
    err = float((pv / denom(l) - wpv / denom(wl)).abs().max())
    check(err <= 2e-2, f"{what}: normalised pv error {err} beyond 2e-2")
    check(bool(((l - wl).abs() <= 2e-2 * wl.abs() + 2e-2).all()), f"{what}: l beyond 2e-2")
    return err


def phase_k3():
    g = torch.Generator(device="cuda").manual_seed(3)
    bh, d = 32, 128
    scale = 1.0 / d ** 0.5

    def qkv(sq, sk):
        mk = lambda n: torch.randn((bh, n, d), device="cuda", generator=g).to(torch.bfloat16)  # noqa: E731
        return mk(sq), mk(sk), mk(sk)

    cases = [("main", SEQ, SEQ, 0, 0), ("ragged", 2000, 1900, 0, 0), ("q_offset", 1024, SEQ, 1024, 0)]
    main_err = None
    for what, sq, sk, qo, ko in cases:
        q, k, v = qkv(sq, sk)
        got = flash_attention.attend_partials(q, k, v, qo, ko, True, scale)
        want = flash_attention.attend_partials_plain(q, k, v, qo, ko, True, scale, sq, sk)
        err = compare_partials(got, want, f"K3 {what}")
        print(f"K3 {what} (sq={sq}, sk={sk}, q_offset={qo}): normalised max abs err {err:.3e}")
        if what == "main":
            main_err, main = err, (q, k, v)
    q, k, v = main
    ms = time_ms(lambda: flash_attention.attend_partials(q, k, v, 0, 0, True, scale), iters=10)
    plain_ms = time_ms(
        lambda: flash_attention.attend_partials_plain(q, k, v, 0, 0, True, scale, SEQ, SEQ), iters=5
    )
    qs, ks, vs = (t.unsqueeze(0) for t in (q, k, v))  # [1, h, s, d]
    library_ms = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, is_causal=True), iters=10
    )
    pairs = SEQ * (SEQ + 1) // 2  # causal (query, key) pairs this run computes
    flops = 4 * bh * d * pairs
    io_bytes = 3 * bh * SEQ * d * 2 + bh * SEQ * d * 4 + 2 * bh * SEQ * 4
    t_ops, t_bytes = flops / BF16_FLOP_PER_S, io_bytes / HBM_BYTES_PER_S
    return kernel_record(
        "flash_attention_fwd", "torchsnapshot_tpu_torch/csrc/flash_attention_fwd.cu",
        "torchsnapshot_tpu/ops/flash_attention.py:136", main_err, ms, plain_ms,
        max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes", library_ms,
    )


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
    """One thread's crc32 + adler32 rate over 256 MiB (the digests every
    staged byte pays during take): where take's host time goes."""
    import zlib

    import numpy as np

    buf = np.random.default_rng(0).integers(0, 256, 256 << 20, dtype=np.uint8)
    t0 = time.perf_counter()
    zlib.crc32(buf)
    zlib.adler32(buf)
    dt = time.perf_counter() - t0
    print(f"host digest rate (crc32 + adler32, one thread): {buf.nbytes / dt / 1e9:.3f} GB/s; "
          f"host cores: {os.cpu_count()}")


def phase_attention(cfg, model):
    g = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, cfg.vocab, (1, SEQ), device="cuda", generator=g)
    positions = torch.arange(SEQ, device="cuda").expand(tokens.shape)
    layer = model.layer0
    with torch.no_grad():
        x = model.embed(tokens)
        q, k, v = layer.attn.qkv(layer.norm1(x), positions)
        out = ring_attention(q, k, v, causal=True)
        want = dense_attention(q.float(), k.float(), v.float(), causal=True)
    torch.cuda.synchronize()
    err = float((out.float() - want).abs().max())
    check(bool(torch.isfinite(out).all()) and out.shape == q.shape, "ring attention output malformed")
    check(err <= 2e-2, f"ring attention vs dense: max abs err {err} beyond 2e-2")
    print(f"ring attention on restored layer0 (s={SEQ}): max abs err vs f32 dense {err:.3e}")


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
    for name, log in kernels.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    cfg = TransformerConfig(n_layers=N_LAYERS)
    torch.manual_seed(0)
    model = TransformerLM(cfg, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params} parameters, {cfg}")

    members = first_device_slab(model)
    slab, k1 = phase_k1(members)
    k2 = phase_k2(slab, members)
    k3 = phase_k3()
    del slab

    tokens = torch.randint(0, cfg.vocab, (1, 129), device="cuda")
    opt = adamw_step(model, tokens)
    for table in (device_pack.LAUNCHES, flash_attention.LAUNCHES):
        for key in table:
            table[key] = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        model2 = phase_main_path(cfg, model, opt, os.path.join(root, "snap"))
    phase_attention(cfg, model2)
    host_digest_rate()
    torch.cuda.synchronize()
    k1["launches"] = device_pack.LAUNCHES["slab_pack"]
    k2["launches"] = device_pack.LAUNCHES["slab_unpack"]
    k3["launches"] = flash_attention.LAUNCHES["flash_fwd"]
    for rec in (k1, k2, k3):
        check(rec["launches"] > 0, f"{rec['name']} was not launched on the main path")
    print(f"peak device memory: {torch.cuda.max_memory_allocated()} bytes")

    print(json.dumps({"kernels": [k1, k2, k3]}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
