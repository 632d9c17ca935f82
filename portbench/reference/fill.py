"""Leaf values drawn from the seed.

Every leaf of a benchmark state is a function of ``(seed, version,
index)``: ``version`` counts the in-place updates the state has seen
and ``index`` is the leaf's place in its builder's list.  The harness
fills the program's tensors with these values, and the reference draws
them again to judge what the program stored or restored.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

import torch

# kinds of leaf: "normal" draws N(0, 1); "nonneg" takes its absolute
# value (second moments, Adagrad sums)
KINDS = ("normal", "nonneg")


def leaf_seed(seed: int, version: int, index: int) -> int:
    """A 63-bit generator seed of the leaf, for any whole ``seed``."""
    digest = hashlib.blake2b(f"{seed}:{version}:{index}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def fill_(t: torch.Tensor, seed: int, version: int, index: int, kind: str) -> torch.Tensor:
    """Overwrite ``t`` in place, on its own device and current stream."""
    if kind not in KINDS:
        raise ValueError(f"unknown leaf kind {kind!r}")
    g = torch.Generator(device=t.device)
    g.manual_seed(leaf_seed(seed, version, index))
    with torch.no_grad():
        t.normal_(0.0, 1.0, generator=g)
        if kind == "nonneg":
            t.abs_()
    return t


def expected(
    shape: Sequence[int], dtype: torch.dtype, device, seed: int, version: int, index: int,
    kind: str,
) -> torch.Tensor:
    """The leaf's value at ``version``, made anew."""
    return fill_(torch.empty(tuple(shape), dtype=dtype, device=device), seed, version, index, kind)
