"""Traffic loops, one module per ``loop`` named in a traffic file.  Each
has a ``Loop(state, traffic, device, annotate)`` with ``setup()``,
``run(seconds) -> stats.Window``, ``verify() -> checks`` and ``close()``."""

from typing import Any

import torch


def synchronize(device: Any) -> None:
    """Wait for the device's queued work (nothing on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
