"""Kernel K2 (slab unpack, ``csrc/slab_unpack.cu``): share of its HBM roofline, %."""

import math

from portbench.kernels import DTYPE_BYTES
from portbench.kernels import nbytes as _nbytes
from portbench.readers import kernel_roofline

ENTRY = "torchsnapshot_tpu_torch.ops.device_pack:unpack_slab_into"
TRACE_NAME = "slab_unpack_kernel"


def nbytes(slab, members, outs, *_, **__) -> int:
    """Each member's stored bytes read, each output written."""
    if slab.device.type != "cuda":
        return 0
    stored = sum(math.prod(shape) * DTYPE_BYTES[dt] for _, dt, shape in members)
    return stored + sum(_nbytes(o) for o in outs)


def value(ctx):
    return kernel_roofline(ctx, TRACE_NAME)
