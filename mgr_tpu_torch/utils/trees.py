"""Helpers over trees of tensors (``mgr_tpu/utils/trees.py``): nested
dicts, lists and tuples whose leaves are tensors or arrays, as a
``state_dict()`` or a train state's parameters are. Dict keys are visited
in sorted order, as ``jax.tree`` visits them."""

from __future__ import annotations

from typing import Any, List

import torch


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in order (``None`` is an empty subtree)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def _structure(tree: Any) -> Any:
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_structure(v) for v in tree))
    return None if tree is None else "*"


def tree_count_params(tree: Any) -> int:
    """Total number of scalar parameters in a tree."""
    return sum(int(torch.as_tensor(x).numel()) for x in tree_leaves(tree)
               if hasattr(x, "shape"))


def tree_norm(tree: Any) -> torch.Tensor:
    """Global L2 norm of all leaves, summed in f32 (a 0-d tensor)."""
    sums = [torch.sum(torch.square(torch.as_tensor(x).float()))
            for x in tree_leaves(tree) if hasattr(x, "shape")]
    return torch.sqrt(sum(sums)) if sums else torch.zeros(())


def tree_equal(a: Any, b: Any) -> bool:
    """Exact structural and value equality of two trees (compared on the
    host; NaN equals nothing, as in ``np.array_equal``)."""
    if _structure(a) != _structure(b):
        return False
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        x, y = torch.as_tensor(x).cpu(), torch.as_tensor(y).cpu()
        if x.shape != y.shape or not bool(torch.eq(x, y).all()):
            return False
    return True
