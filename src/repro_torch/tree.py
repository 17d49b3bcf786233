"""Trees of tensors: nested dicts, lists, tuples and NamedTuples (a param
tree, an ``AdamWState``, a ``TrainState``), walked in jax's leaf order
(dict keys sorted, sequences and fields in order).

A leaf's path is its dict keys, field names and sequence indices, each
behind a ``/`` (``/params/run_0/attn/wq``), as the checkpoints of both
packages key their leaves.
"""
from __future__ import annotations

from typing import Any, Callable, List, Mapping, Tuple


def tree_flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in jax's leaf order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_flatten(tree[k], f"{prefix}/{k}")]
    if hasattr(tree, "_fields"):                # NamedTuple
        return [x for k, v in zip(tree._fields, tree)
                for x in tree_flatten(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in tree_flatten(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def tree_unflatten(like: Any, values: Mapping[str, Any],
                   prefix: str = "") -> Any:
    """``like``'s structure with each leaf replaced by ``values`` at its
    path."""
    if isinstance(like, dict):
        return {k: tree_unflatten(v, values, f"{prefix}/{k}")
                for k, v in like.items()}
    if hasattr(like, "_fields"):
        return type(like)(*(tree_unflatten(v, values, f"{prefix}/{k}")
                            for k, v in zip(like._fields, like)))
    if isinstance(like, (list, tuple)):
        return type(like)(tree_unflatten(v, values, f"{prefix}/{i}")
                          for i, v in enumerate(like))
    return values[prefix]


def tree_leaves(tree: Any) -> list:
    """The leaves in jax's order."""
    return [leaf for _, leaf in tree_flatten(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the leaves at the same
    paths of each tree in ``rest``, keeping ``tree``'s structure."""
    others = [dict(tree_flatten(r)) for r in rest]
    return tree_unflatten(tree, {p: fn(x, *(o[p] for o in others))
                                 for p, x in tree_flatten(tree)})
