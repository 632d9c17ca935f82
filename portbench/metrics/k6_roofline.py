"""Kernel K6 (tile update, ``csrc/tile_update.cu``): share of its HBM roofline, %."""

from portbench.readers import kernel_roofline

ENTRY = "torchsnapshot_tpu_torch.ops.device_pack:tile_update"
TRACE_NAME = "tile_update_kernel"


def nbytes(dst, off, tile, *_, **__) -> int:
    """The tile read, its elements written in the template's dtype."""
    if dst.device.type != "cuda":
        return 0
    return tile.numel() * (tile.element_size() + dst.element_size())


def value(ctx):
    return kernel_roofline(ctx, TRACE_NAME)
