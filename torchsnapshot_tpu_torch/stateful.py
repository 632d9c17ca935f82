"""The checkpointable-object protocol and built-in helpers.

Counterpart of ``torchsnapshot_tpu/stateful.py``.  ``nn.Module`` and
``torch.optim.Optimizer`` are Stateful as they are, through their own
``state_dict``/``load_state_dict``.  ``PyTreeState`` wraps a nested
structure of dicts, lists and tuples of tensors and renders it as the
JAX package renders a pytree (a nested NAMED dict, dict keys sorted,
sequence positions as string keys, ``None`` as no leaf), so the two
packages write the same manifest for the same tree.  ``Replicated``
marks a stateful whose whole state every rank holds identically.
Snapshots of the leaf-list era (``<key>/leaves/<i>``) load into a
``PyTreeState`` positionally.  ``DTensor`` parameters and optimizer
states restore in place into their local tensors, so an ``nn.Module``
and a ``torch.optim`` optimizer keep their own (sharded) tensors.
"""

from __future__ import annotations

import collections.abc
import inspect
import random
from collections import UserDict
from typing import Any, Dict, List, Protocol, Tuple, runtime_checkable

import numpy as np
import torch


@runtime_checkable
class Stateful(Protocol):
    def state_dict(self) -> Dict[str, Any]: ...

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None: ...


class StateDict(UserDict):
    """Dict wrapper making plain values checkpointable."""

    def state_dict(self) -> Dict[str, Any]:
        return self.data

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        self.data.update(state_dict)


_ROOT_LEAF_KEY = "__root__"


def _tree_path_keys(tree: Any, prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    """[(path_key_strings, leaf), ...] in the order jax's tree_flatten
    visits them: dict keys sorted, sequences by position, ``None`` is an
    empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_tree_path_keys(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_tree_path_keys(v, prefix + (str(i),)))
        return out
    return [(prefix or (_ROOT_LEAF_KEY,), tree)]


def _rebuild(tree: Any, leaves) -> Any:
    """``tree`` with its leaves replaced, in ``_tree_path_keys`` order,
    by the values of the iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        new = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return type(tree)((k, new[k]) for k in tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _leaf_paths_of(node: Any, prefix: tuple = ()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaf_paths_of(v, prefix + (str(k),))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _leaf_paths_of(v, prefix + (str(i),))
    else:
        yield prefix or (_ROOT_LEAF_KEY,)


class PyTreeState:
    """Checkpointable wrapper around nested dicts/lists/tuples of tensors.

    ``load_state_dict`` maps the named dict back onto the CURRENT tree's
    structure, keeping the current leaf for paths missing from the
    snapshot when ``strict=False``.  Tensor leaves are restore templates:
    restore copies into them in place."""

    def __init__(self, tree: Any) -> None:
        self.tree = tree

    def state_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for keys, leaf in _tree_path_keys(self.tree):
            node = out
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = leaf
        return out

    def load_state_dict(
        self, state_dict: Dict[str, Any], strict: bool = True
    ) -> None:
        if self._is_legacy_format(state_dict):
            # a snapshot of the leaf-list era: leaves in flattening order
            leaves = list(state_dict["leaves"])
            n = len(_tree_path_keys(self.tree))
            if n != len(leaves):
                raise ValueError(f"cannot load {len(leaves)} leaves into a tree with {n} leaves")
            self.tree = _rebuild(self.tree, iter(leaves))
            return
        new_leaves = []
        missing = []
        consumed = set()
        for keys, current in _tree_path_keys(self.tree):
            node: Any = state_dict
            try:
                for k in keys:
                    node = (
                        node[int(k)]
                        if isinstance(node, (list, tuple))
                        else node[k]
                    )
                if isinstance(node, (dict, list, tuple)):
                    raise KeyError(keys)
                consumed.add(keys)
            except (KeyError, TypeError, IndexError, ValueError):
                missing.append("/".join(keys))
                node = current
            new_leaves.append(node)
        if strict:
            surplus = [
                "/".join(p)
                for p in _leaf_paths_of(state_dict)
                if p not in consumed
            ]
            if missing or surplus:
                raise ValueError(
                    f"structure mismatch (pass strict=False for elastic "
                    f"load): {len(missing)} template path(s) missing from "
                    f"snapshot {missing[:5]}, {len(surplus)} snapshot "
                    f"path(s) absent from template {surplus[:5]}"
                )
        self.tree = _rebuild(self.tree, iter(new_leaves))

    def _is_legacy_format(self, state_dict: Dict[str, Any]) -> bool:
        """``{"leaves": [...]}`` is the leaf-list layout, unless the tree
        itself has that shape (then both layouts coincide)."""
        if set(state_dict) != {"leaves"} or not isinstance(state_dict["leaves"], (list, tuple)):
            return False
        return not all(keys[0] == "leaves" for keys, _ in _tree_path_keys(self.tree))


class Replicated:
    """Marker wrapper declaring a stateful's entire state replicated
    across ranks: every rank holds the same copy, so ``Snapshot.take``
    adds a ``key/**`` replication glob, balances the writes across ranks
    and persists one copy.  Content verification still applies: a wrong
    claim is demoted to per-rank entries rather than saving one rank's
    copy for all."""

    replicated = True

    def __init__(self, stateful: Any) -> None:
        if isinstance(stateful, RNGState):
            # RNG streams are per-rank state, and the take's capture and
            # restore of RNGState keys is keyed on isinstance
            raise ValueError(
                "Replicated(RNGState()) is not supported: pass the "
                "RNGState directly (RNG streams are per-rank state)"
            )
        if not isinstance(stateful, Stateful):
            if not isinstance(stateful, collections.abc.MutableMapping):
                raise TypeError(
                    "Replicated(...) takes a Stateful or a mutable mapping; "
                    f"got {type(stateful).__name__}"
                )
            # share the caller's mapping, so a restore through the
            # wrapper shows in the original dict
            wrapped = StateDict()
            wrapped.data = stateful
            stateful = wrapped
        self.stateful = stateful

    def state_dict(self) -> Dict[str, Any]:
        return self.stateful.state_dict()

    def load_state_dict(self, state_dict: Dict[str, Any], strict: bool = True) -> None:
        # ``strict`` declared by name so restore's signature probe sees it
        load_with_strict(self.stateful, state_dict, strict)


def load_with_strict(stateful: Any, state_dict: Dict[str, Any], strict: bool) -> None:
    """Call ``load_state_dict``, forwarding ``strict`` only when the
    stateful's signature accepts it (``nn.Module`` does,
    ``Optimizer`` does not)."""
    try:
        accepts = "strict" in inspect.signature(
            stateful.load_state_dict
        ).parameters
    except (TypeError, ValueError):
        accepts = False
    if accepts:
        stateful.load_state_dict(state_dict, strict=strict)
    else:
        stateful.load_state_dict(state_dict)


class RNGState:
    """Captures/restores the host and device RNG streams.

    ``python`` and ``numpy`` are the JAX package's keys; ``torch`` is the
    CPU generator's state and ``torch_cuda`` the states of the CUDA
    generators (present when CUDA is)."""

    def state_dict(self) -> Dict[str, Any]:
        out = {
            "python": random.getstate(),
            "numpy": np.random.get_state(),
            "torch": torch.get_rng_state(),
        }
        if torch.cuda.is_available():
            out["torch_cuda"] = torch.cuda.get_rng_state_all()
        return out

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        random.setstate(_as_tuple(state_dict["python"]))
        np.random.set_state(_as_tuple(state_dict["numpy"]))
        if "torch" in state_dict:
            torch.set_rng_state(state_dict["torch"])
        if "torch_cuda" in state_dict and torch.cuda.is_available():
            torch.cuda.set_rng_state_all(list(state_dict["torch_cuda"]))


def _as_tuple(v: Any) -> Any:
    # random.setstate requires tuples, nested ones included
    if isinstance(v, (list, tuple)):
        return tuple(_as_tuple(x) for x in v)
    return v
