#!/usr/bin/env python3
"""Same-call A/B of the port's kernels on one NVIDIA GPU.

    python3 chip_ab_flash_bwd.py LABEL=CSRC_DIR [cut-softmax] [LABEL=CSRC_DIR ...]

Each CSRC_DIR is a ``torchsnapshot_tpu_torch/csrc`` directory: of an
older checkout (``git archive <commit> torchsnapshot_tpu_torch/csrc``
unpacked somewhere) or an edited copy of the current one.
``cut-softmax`` stands for a copy of the current csrc
whose K3 skips its softmax (see ``cut_softmax_dir``). Its K1
(``slab_pack.cu``), K2 (``slab_unpack.cu``), K3
(``flash_attention_fwd.cu``), K4 (``flash_attention_bwd_dq.cu``) and K5
(``flash_attention_bwd_dkv.cu``) are built beside the current ones
("new", built through ``ops.kernels``), one nvcc each, in parallel.

Shapes: K3-K5 at the ring-attention shape (bh = 32, s = 2048, d = 128,
bf16, causal); K1 and K2 on four 32 MiB bf16 members (the size of the
take's first device slab) "aligned", and the same members each followed
by a 4-byte f32 scalar "misaligned" (every member after the first off
16-byte alignment in the slab), K2 unpacking each slab into templates of
the stored dtypes, and K2 as chip_smoke.py runs it ("cast": the aligned
slab and a 4099-byte bool, member 0 cast bf16 -> f32). Every version is
held against the plain versions (K1/K2 bitwise; K3's normalised pv and
K4/K5's outputs within 2e-2; a version labelled ``cut-...``, with parts
taken out to see what they cost, is reported and not held), then timed
in the order given, "new", "new" and the given order reversed (old, new,
new, old for one directory): each entry the median of 5 timings of 10
launches, with its range. K1 of an older tree takes its descriptor table
in device memory (uploaded once here); directories without
``hopper_common.cuh`` hold the K4/K5 from before gpv crossed the C
interface in bf16 (they took it in f32) and are given the same values in
f32. Prints the card, what ptxas reports for each build, and one line
per timing.
"""

import ctypes
import os
import shutil
import subprocess
import sys

import torch

from chip_smoke import card_line, causal_pairs, interleave_steps, time_ms_repeats
from torchsnapshot_tpu_torch.ops import device_pack, flash_attention, kernels

SEQ, BH, D = 2048, 32, 128
BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "ab")
NAMES = {"fwd": "flash_attention_fwd", "dq": "flash_attention_bwd_dq",
         "dkv": "flash_attention_bwd_dkv", "pack": "slab_pack", "unpack": "slab_unpack"}
OLD_PACK_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]


def build(label, csrc):
    """The five kernels of ``csrc``, one nvcc each, in parallel: key → CDLL."""
    os.makedirs(os.path.join(BUILD, label), exist_ok=True)
    procs = {}
    for key, name in NAMES.items():
        out = os.path.join(BUILD, label, f"{name}.so")
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", out, os.path.join(csrc, f"{name}.cu")]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for key, (proc, out) in procs.items():
        log, _ = proc.communicate()
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "C75" in line:
                print(f"ptxas {label} {NAMES[key]}: {line.strip()}")
        if proc.returncode != 0:
            raise RuntimeError(f"{label} {NAMES[key]} failed to build:\n{log}")
        cdll = ctypes.CDLL(out)
        for sym, (restype, argtypes) in kernels._SIGNATURES[NAMES[key]].items():
            fn = getattr(cdll, sym, None)
            if fn is not None:
                fn.restype, fn.argtypes = restype, argtypes
        if key == "pack" and not hasattr(cdll, "tsnp_slab_pack_inline_members"):
            cdll.tsnp_slab_pack.argtypes = OLD_PACK_ARGS
        libs[key] = cdll
    return libs, os.path.exists(os.path.join(csrc, "hopper_common.cuh"))


def nbytes(t):
    return t.numel() * t.element_size()


def pack_launch(lib, members, slab):
    """K1 of ``lib`` on ``members`` into ``slab``: its table built as that
    version's wrapper builds it, then the launch alone."""
    stream = torch.cuda.current_stream().cuda_stream
    plan, total_chunks, _ = device_pack.pack_plan([nbytes(t) for t in members],
                                                  lib.tsnp_slab_pack_chunk_bytes())
    rows = [(t.data_ptr(), *row) for t, row in zip(members, plan)]
    if hasattr(lib, "tsnp_slab_pack_inline_members"):
        table, on_device = device_pack.descriptor_table(rows, lib.tsnp_slab_pack_inline_members(),
                                                        slab.device)
        return lambda: lib.tsnp_slab_pack(table.data_ptr(), on_device, len(rows), total_chunks,
                                          slab.data_ptr(), stream)
    table = device_pack._upload_table(rows, slab.device)
    return lambda: lib.tsnp_slab_pack(table.data_ptr(), len(rows), total_chunks, slab.data_ptr(), stream)


def unpack_launch(lib, slab, members, outs):
    """K2 of ``lib`` into ``outs``: identity members, but a bf16 member
    whose template is f32 is cast (codes of ``device_pack._CODES``)."""
    stream = torch.cuda.current_stream().cuda_stream
    chunk, chunk_elems = lib.tsnp_slab_unpack_chunk_bytes(), lib.tsnp_slab_unpack_chunk_elems()
    rows, off, chunk_begin = [], 0, 0
    for t, o in zip(members, outs):
        if t.dtype == o.dtype:
            rows.append((off, o.data_ptr(), nbytes(t), 0, 0, chunk_begin))
            chunk_begin += -(-nbytes(t) // chunk)
        else:
            rows.append((off, o.data_ptr(), t.numel(), device_pack._CODES[t.dtype],
                         device_pack._CODES[o.dtype], chunk_begin))
            chunk_begin += -(-t.numel() // chunk_elems)
        off += nbytes(t)
    table = device_pack._upload_table(rows, slab.device)
    return lambda: lib.tsnp_slab_unpack(table.data_ptr(), len(rows), chunk_begin, slab.data_ptr(), stream)


def cut_softmax_dir():
    """A copy of the current csrc whose K3 has its softmax cut out: each
    step's raw scores go to the p v product and o is never rescaled, so
    K3 costs what its loads and products cost alone."""
    dst = os.path.join(BUILD, "cut-softmax-src")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(kernels.CSRC_DIR, dst)
    path = os.path.join(dst, "flash_attention_fwd.cu")
    with open(path) as f:
        src = f.read()
    a, b = src.index("  auto softmax = [&](int i, auto masked) {"), src.index("  auto pack_p = [&]() {")
    with open(path, "w") as f:
        f.write(src[:a] + "  auto softmax = [&](int, auto) { corr[0] = corr[1] = 1.f; };\n" + src[b:])
    return dst


def main():
    dirs = []
    for a in sys.argv[1:]:
        if a == "cut-softmax":
            dirs.append((a, cut_softmax_dir()))
            continue
        label, _, csrc = a.partition("=")
        dirs.append((label, csrc))
    if not dirs or any(not label or not csrc for label, csrc in dirs) or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    versions = {label: build(label, csrc) for label, csrc in dirs}
    versions["new"] = ({key: kernels.lib(name) for key, name in NAMES.items()}, True)

    g = torch.Generator(device="cuda").manual_seed(4)
    scale = 1.0 / D ** 0.5
    q, k, v = (torch.randn((BH, SEQ, D), device="cuda", generator=g).to(torch.bfloat16) for _ in range(3))
    want_fwd = flash_attention.attend_partials_plain(q, k, v, 0, 0, True, scale, SEQ, SEQ)
    m = torch.where(torch.isfinite(want_fwd[1]), want_fwd[1], 0.0).contiguous()
    gpv = torch.randn((BH, SEQ, D), device="cuda", generator=g).to(torch.bfloat16)
    gl = torch.randn((BH, SEQ), device="cuda", generator=g)
    want = flash_attention.flash_bwd_plain(q, k, v, m, gpv, gl, 0, 0, True, scale, SEQ, SEQ)
    outs = [torch.empty((BH, SEQ, D), device="cuda") for _ in range(3)]
    amax = torch.empty((BH, SEQ), dtype=torch.int32, device="cuda")
    fwd_out = [torch.empty((BH, SEQ, D), device="cuda"), torch.empty((BH, SEQ), device="cuda"),
               torch.empty((BH, SEQ), device="cuda")]
    stream = torch.cuda.current_stream().cuda_stream
    args = (BH, SEQ, SEQ, D, scale, 1, 0, 0, SEQ, SEQ, 1, stream)
    gpv_f32 = gpv.float()
    slabs = {}
    members = [torch.randn((4096, 4096), device="cuda", generator=g).to(torch.bfloat16) for _ in range(4)]
    for what, ms in (("aligned", members), ("misaligned", interleave_steps(members))):
        want_slab = device_pack.pack_slab_plain(ms)
        slabs[what] = (ms, want_slab, torch.empty_like(want_slab), [torch.empty_like(t) for t in ms])
    # chip_smoke's K2 case: the aligned slab and a 4099-byte bool, member 0
    # cast bf16 -> f32
    flags = torch.rand(4099, device="cuda", generator=g) > 0.5
    cast_members = members + [flags]
    cast_slab = device_pack.pack_slab_plain(cast_members)
    cast_outs = [torch.empty(members[0].shape, device="cuda")] + [torch.empty_like(t) for t in cast_members[1:]]

    launches = {}
    for label, (libs, bf16_gpv) in versions.items():
        ins = [t.data_ptr() for t in (q, k, v, m, gpv if bf16_gpv else gpv_f32, gl)]
        fns = {
            "fwd": lambda libs=libs: libs["fwd"].tsnp_flash_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), *(t.data_ptr() for t in fwd_out), *args),
            "dq": lambda libs=libs, ins=ins: libs["dq"].tsnp_flash_bwd_dq(
                *ins, outs[0].data_ptr(), amax.data_ptr(), *args),
            "dkv": lambda libs=libs, ins=ins: libs["dkv"].tsnp_flash_bwd_dkv(
                *ins, outs[1].data_ptr(), outs[2].data_ptr(), *args),
        }
        for what, (ms, want_slab, slab, templates) in slabs.items():
            fns[f"pack_{what}"] = pack_launch(libs["pack"], ms, slab)
            fns[f"unpack_{what}"] = unpack_launch(libs["unpack"], want_slab, ms, templates)
        fns["unpack_cast"] = unpack_launch(libs["unpack"], cast_slab, cast_members, cast_outs)
        launches[label] = fns
        for key, fn in fns.items():
            kernels.check(fn(), f"{label} {key}")
        torch.cuda.synchronize()
        held = not label.startswith("cut-")
        denom = lambda x: torch.where(x == 0, 1.0, x)[..., None]  # noqa: E731
        fwd_err = float((fwd_out[0] / denom(fwd_out[2]) - want_fwd[0] / denom(want_fwd[2])).abs().max())
        bwd_errs = [float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(outs, want[:3])]
        slab_ok = all(torch.equal(slab, want_slab) and all(torch.equal(o, t) for o, t in zip(templates, ms))
                      for ms, want_slab, slab, templates in slabs.values())
        slab_ok = slab_ok and torch.equal(cast_outs[0], members[0].float()) and all(
            torch.equal(o, t) for o, t in zip(cast_outs[1:], cast_members[1:]))
        print(f"{label}: K3 normalised pv error {fwd_err:.3e}; dq, dk, dv error / largest plain value "
              f"{', '.join(f'{e:.3e}' for e in bwd_errs)}; K1/K2 bitwise on both slabs: {slab_ok}")
        if held and (max([fwd_err] + bwd_errs) > 2e-2 or not slab_ok):
            raise RuntimeError(f"{label}: a kernel disagrees with its plain version")
    pairs = causal_pairs(SEQ, SEQ, 0) * BH
    flops = {"fwd": 4 * D * pairs, "dq": 6 * D * pairs, "dkv": 8 * D * pairs}
    given = [label for label, _ in dirs]
    for label in given + ["new", "new"] + given[::-1]:
        parts = []
        for key, fn in launches[label].items():
            med, lo, hi = time_ms_repeats(fn)
            rate = f", {flops[key] / med / 1e9:.1f} TFLOP/s" if key in flops else ""
            parts.append(f"{key} {med:.4f} ms ({lo:.4f}-{hi:.4f}{rate})")
        print(f"A/B {label}: " + "; ".join(parts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
