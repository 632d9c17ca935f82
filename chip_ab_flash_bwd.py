#!/usr/bin/env python3
"""Same-call A/B of the flash-attention backward kernels on one NVIDIA GPU.

    python3 chip_ab_flash_bwd.py LABEL=CSRC_DIR [LABEL=CSRC_DIR ...]

Each CSRC_DIR is a ``torchsnapshot_tpu_torch/csrc`` directory: of an
older checkout (``git archive <commit> torchsnapshot_tpu_torch/csrc``
unpacked somewhere) or an edited copy of the current one.  Its K4
(``flash_attention_bwd_dq.cu``) and K5 (``flash_attention_bwd_dkv.cu``)
are built with the port's nvcc flags beside the current ones ("new",
built through ``ops.kernels``).  At the ring-attention shape (bh = 32,
s = 2048, d = 128, bf16, causal) every version is held against the
plain backward (2e-2 of the largest plain value; a version labelled
``cut-...``, with parts taken out to see what they cost, is reported and
not held), then timed in the order given, "new", "new" and the given
order reversed (old, new, new, old for one directory): each entry the
median of 5 timings of 10 launches, with its range.  Directories without ``hopper_common.cuh`` hold the kernels
from before gpv crossed the C interface in bf16 (they took it in f32)
and are given the same values in f32.  Prints the card, what ptxas
reports for each build, and one line per timing.
"""

import ctypes
import os
import subprocess
import sys

import torch

from chip_smoke import card_line, causal_pairs, time_ms_repeats
from torchsnapshot_tpu_torch.ops import flash_attention, kernels

SEQ, BH, D = 2048, 32, 128
BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "ab")
NAMES = {"dq": "flash_attention_bwd_dq", "dkv": "flash_attention_bwd_dkv"}
SYMBOLS = {"dq": "tsnp_flash_bwd_dq", "dkv": "tsnp_flash_bwd_dkv"}


def build(label, csrc):
    """K4 and K5 of ``csrc``, one nvcc each, in parallel."""
    os.makedirs(os.path.join(BUILD, label), exist_ok=True)
    procs = {}
    for key, name in NAMES.items():
        out = os.path.join(BUILD, label, f"{name}.so")
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", out, os.path.join(csrc, f"{name}.cu")]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    fns = {}
    for key, (proc, out) in procs.items():
        log, _ = proc.communicate()
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "C75" in line:
                print(f"ptxas {label} {NAMES[key]}: {line.strip()}")
        if proc.returncode != 0:
            raise RuntimeError(f"{label} {NAMES[key]} failed to build:\n{log}")
        fn = getattr(ctypes.CDLL(out), SYMBOLS[key])
        fn.restype, fn.argtypes = ctypes.c_int, kernels._FLASH_BWD_ARGS
        fns[key] = fn
    return fns, os.path.exists(os.path.join(csrc, "hopper_common.cuh"))


def main():
    dirs = [a.split("=", 1) for a in sys.argv[1:]]
    if not dirs or any(len(x) != 2 for x in dirs) or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    versions = {label: build(label, csrc) for label, csrc in dirs}
    versions["new"] = ({key: getattr(kernels.lib(NAMES[key]), SYMBOLS[key]) for key in NAMES}, True)

    g = torch.Generator(device="cuda").manual_seed(4)
    scale = 1.0 / D ** 0.5
    q, k, v = (torch.randn((BH, SEQ, D), device="cuda", generator=g).to(torch.bfloat16) for _ in range(3))
    _, m, _ = flash_attention.attend_partials(q, k, v, 0, 0, True, scale)
    m = torch.where(torch.isfinite(m), m, 0.0).contiguous()
    gpv = torch.randn((BH, SEQ, D), device="cuda", generator=g).to(torch.bfloat16)
    gl = torch.randn((BH, SEQ), device="cuda", generator=g)
    want = flash_attention.flash_bwd_plain(q, k, v, m, gpv, gl, 0, 0, True, scale, SEQ, SEQ)
    outs = [torch.empty((BH, SEQ, D), device="cuda") for _ in range(3)]
    amax = torch.empty((BH, SEQ), dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    args = (BH, SEQ, SEQ, D, scale, 1, 0, 0, SEQ, SEQ, 1, stream)
    gpv_f32 = gpv.float()

    launches = {}
    for label, (fns, bf16_gpv) in versions.items():
        ins = [t.data_ptr() for t in (q, k, v, m, gpv if bf16_gpv else gpv_f32, gl)]
        launches[label] = (
            lambda fns=fns, ins=ins: fns["dq"](*ins, outs[0].data_ptr(), amax.data_ptr(), *args),
            lambda fns=fns, ins=ins: fns["dkv"](*ins, outs[1].data_ptr(), outs[2].data_ptr(), *args),
        )
        for fn, what in zip(launches[label], ("dq", "dkv")):
            kernels.check(fn(), f"{label} {what}")
        torch.cuda.synchronize()
        errs = [float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(outs, want[:3])]
        print(f"{label}: dq, dk, dv error / largest plain value {', '.join(f'{e:.3e}' for e in errs)}")
        if not label.startswith("cut-") and max(errs) > 2e-2:
            raise RuntimeError(f"{label}: error {max(errs)} beyond 2e-2 of the largest plain value")
    flops = {"dq": 6 * D * causal_pairs(SEQ, SEQ, 0) * BH, "dkv": 8 * D * causal_pairs(SEQ, SEQ, 0) * BH}
    given = [label for label, _ in dirs]
    for label in given + ["new", "new"] + given[::-1]:
        parts, total = [], 0.0
        for key, fn in zip(("dq", "dkv"), launches[label]):
            med, lo, hi = time_ms_repeats(fn)
            total += med
            parts.append(f"{NAMES[key]} {med:.4f} ms ({lo:.4f}-{hi:.4f}, {flops[key] / med / 1e9:.1f} TFLOP/s)")
        print(f"A/B {label}: " + "; ".join(parts) + f"; both {total:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
