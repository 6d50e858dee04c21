"""Nested dict / list trees of tensors: the few tree operations the trainer,
the optimizer and the checkpointer share.

Leaves come in the JAX package's ``tree_leaves`` order: a dict's keys
sorted, a list's items in index order.  A leaf's key is its path joined by
``/`` (``params/blocks/attn/wq``, ``groups/b0_rec/...``, ``tail/1/...``),
as ``jax.tree_util.tree_flatten_with_path`` names it in the JAX
checkpointer.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def items(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(key, leaf) pairs in leaf order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from items(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from items(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in items(tree)]


def map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``, which
    share its structure."""
    if isinstance(tree, dict):
        return {k: map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def unflatten(tree, new_leaves: List[Any]):
    """``tree``'s structure with ``new_leaves`` (in leaf order) in its place."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def copy_into(dst, src) -> None:
    """Copy each leaf of ``src`` into the tensor at the same place in
    ``dst``, in place (across devices where they differ)."""
    for (kd, d), (ks, s) in zip(items(dst), items(src), strict=True):
        if kd != ks:
            raise ValueError(f"tree keys differ: {kd} and {ks}")
        d.copy_(s)
