"""Kernel K1 (slab pack, ``csrc/slab_pack.cu``): share of its HBM roofline, %."""

from portbench.kernels import nbytes as _nbytes
from portbench.readers import kernel_roofline

ENTRY = "torchsnapshot_tpu_torch.ops.device_pack:pack_slab"
TRACE_NAME = "slab_pack_kernel"


def nbytes(tensors, *_, **__) -> int:
    """Every member read, the slab (their bytes back to back) written."""
    if not tensors or any(t.device.type != "cuda" for t in tensors):
        return 0
    return 2 * sum(_nbytes(t) for t in tensors)


def value(ctx):
    return kernel_roofline(ctx, TRACE_NAME)
