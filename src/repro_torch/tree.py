"""Nested dicts / lists / tuples of tensors: the port's pytrees.

The reference keeps each per-layer parameter of a segment as one leaf
stacked ``[n_layers, ...]``; the port keeps a list of per-layer dicts under
``tree["segments"][s]``. A zamba group segment is ``{"inner": [[layer] *
inner] * groups, "shared": block}``: the reference stacks its inner leaves
``[groups, inner, ...]`` and keeps the shared block unstacked.
``reference_leaves`` groups the port's tensors back into the reference's
leaves, for the code whose arithmetic spans a whole reference leaf (the
int8 codec's max-abs scale, adafactor's factored moments and its update
clipping).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in a fixed order (dict insertion order, then list order)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_size(tree) -> int:
    """Elements over all leaves: a parameter tree's own parameter count."""
    return sum(t.numel() for t in tree_leaves(tree))


def tree_unflatten(like, leaves) -> Any:
    """``like``'s structure with ``leaves`` in ``tree_leaves`` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, list):
            return [build(v) for v in t]
        if isinstance(t, tuple):
            return tuple(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the structure holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` leafwise over trees of one structure, matching dict entries by
    key (so the order of a dict's keys may differ between the trees), and
    in ``tree``'s order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if any(len(r) != len(tree) for r in rest):
            raise ValueError("tree_map: sequences of different lengths")
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def _paths(tree, path=()) -> List[Tuple]:
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _paths(v, path + (i,))]
    return [path]


# Path prefixes under which the port keeps a list of layers, each followed
# by the segment index and then the layer index: the decoder's segments and
# an encoder's.
_STACKS = (("segments",), ("encoder", "segments"))


def _reference_key(path) -> Tuple:
    """The reference leaf ``path`` belongs to: without its layer index (a
    zamba group's inner leaves without their group and layer indices)."""
    for pre in _STACKS:
        n = len(pre) + 1                   # the stack prefix and segment index
        if path[:len(pre)] == pre:
            if path[n] == "shared":
                return path
            if path[n] == "inner":
                return path[:n + 1] + path[n + 3:]
            return path[:n] + path[n + 1:]
    return path


def stack_dims(tree, key: Tuple) -> Tuple[int, ...]:
    """The layer axes the reference leaf ``key`` of ``tree`` stacks: () for
    an unstacked leaf, (n_layers,), or (groups, inner) for a zamba group's
    inner leaves."""
    for pre in _STACKS:
        n = len(pre) + 1
        if key[:len(pre)] == pre:
            seg = tree
            for k in key[:n]:
                seg = seg[k]
            if isinstance(seg, list):
                return (len(seg),)
            if key[n] == "inner":
                return (len(seg["inner"]), len(seg["inner"][0]))
            return ()
    return ()


def reference_leaves(tree) -> List[Tuple[Tuple, List[int]]]:
    """``(path, indices)`` per reference leaf, the indices into
    ``tree_leaves(tree)``.

    A leaf under ``("segments", s, layer, *rest)`` belongs to the reference
    leaf ``("segments", s, *rest)``, stacked over the layers in order, one
    under ``("encoder", "segments", s, layer, *rest)`` to ``("encoder",
    "segments", s, *rest)``, and one under ``("segments", s, "inner", group,
    layer, *rest)`` to ``("segments", s, "inner", *rest)``, stacked over the
    groups and then the layers of each; any other leaf (a zamba group's
    ``shared`` block, ``mtp``'s) is a reference leaf of its own."""
    groups: Dict[Tuple, List[int]] = {}
    for i, path in enumerate(_paths(tree)):
        groups.setdefault(_reference_key(path), []).append(i)
    return list(groups.items())
