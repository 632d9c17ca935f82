"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled on first use by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface (pointers,
sizes and the stream in, ``cudaGetLastError()`` out) and loaded with
``ctypes``.  All sources compile at once, one ``nvcc`` process each,
into ``build/torch_kernels/`` beside the package; a library's file name
carries the hash of its sources, so an edited kernel is rebuilt and an
unchanged one is reused.  Nothing here runs at import: the CPU tests
import every module, and this machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")

# library name → its source; every .cu also depends on the shared headers
SOURCES = {
    "slab_pack": "slab_pack.cu",
    "slab_unpack": "slab_unpack.cu",
    "tile_update": "tile_update.cu",
    "flash_attention_fwd": "flash_attention_fwd.cu",
    "flash_attention_bwd_dq": "flash_attention_bwd_dq.cu",
    "flash_attention_bwd_dkv": "flash_attention_bwd_dkv.cu",
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# what the last build printed (ptxas register/shared-memory/spill lines)
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built on first use "
        "and need the CUDA toolkit"
    )


def _headers() -> List[str]:
    return sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [SOURCES[name]] + _headers():
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"{name}.{h.hexdigest()[:16]}.so")


def build_all() -> Dict[str, str]:
    """Compile every kernel library that is missing, all in parallel;
    returns name → library path.  Raises with nvcc's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {name: _lib_path(name) for name in SOURCES}
    procs = {}
    for name, path in paths.items():
        if os.path.exists(path):
            continue
        tmp = f"{path}.tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, SOURCES[name])]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
        )
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# q, k, v, m, gpv, gl, two outputs; bh, sq, sk, d; scale; causal;
# q_offset, k_offset; sq_real, sk_real, is_bf16; stream.  gpv is in q's
# dtype: bf16 for the bf16 (TMA + wgmma) kernels, which also take only
# d % 8 == 0 and 16-byte aligned q, k, v and gpv; f32 for the f32 ones.
_FLASH_BWD_ARGS = [_P] * 8 + [_I] * 4 + [_F, _I, _LL, _LL, _I, _I, _I, _P]

# C signatures: (restype, argtypes) per exported symbol
_SIGNATURES = {
    "slab_pack": {
        "tsnp_slab_pack": (_I, [_P, _I, _I, _LL, _P, _P]),
        "tsnp_slab_pack_chunk_bytes": (_LL, []),
        "tsnp_slab_pack_inline_members": (_I, []),
    },
    "slab_unpack": {
        "tsnp_slab_unpack": (_I, [_P, _I, _LL, _P, _P]),
        "tsnp_slab_unpack_chunk_bytes": (_LL, []),
        "tsnp_slab_unpack_chunk_elems": (_LL, []),
    },
    "tile_update": {
        "tsnp_tile_update": (_I, [_P, _P, _LL, _LL, _I, _I, _P]),
    },
    "flash_attention_fwd": {
        "tsnp_flash_fwd": (
            _I,
            [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _LL, _LL,
             _I, _I, _I, _P],
        ),
        "tsnp_flash_fwd_max_head_dim": (_I, []),
    },
    "flash_attention_bwd_dq": {
        "tsnp_flash_bwd_dq": (_I, _FLASH_BWD_ARGS),
        "tsnp_flash_bwd_dq_max_head_dim": (_I, []),
    },
    "flash_attention_bwd_dkv": {
        "tsnp_flash_bwd_dkv": (_I, _FLASH_BWD_ARGS),
    },
}


def lib(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building every kernel on first use."""
    with _LOCK:
        if name not in _LIBS:
            paths = build_all()
            for n, path in paths.items():
                if n in _LIBS:
                    continue
                cdll = ctypes.CDLL(path)
                for sym, (restype, argtypes) in _SIGNATURES[n].items():
                    fn = getattr(cdll, sym)
                    fn.restype = restype
                    fn.argtypes = argtypes
                _LIBS[n] = cdll
        return _LIBS[name]


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
