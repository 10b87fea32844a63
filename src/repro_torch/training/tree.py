"""Trees of tensors: what ``jax.tree_util`` and ``jax.value_and_grad``
give ``repro``'s training code.

A tree is nested dictionaries, lists and tuples with tensors (or any
other object) at its leaves.  Leaves are visited in ``jax.tree_util``'s
order: a dictionary's keys sorted, a sequence's items in order.  A leaf's
path is the string ``repro``'s checkpoints name it by, ``"/".join`` of
``jax``'s key strings: ``['name']`` for a dictionary key, ``[i]`` for a
sequence index, e.g. ``"[0]/['layers']/[0]/['w']"``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

_END = object()  # the end of an iterator of leaves


def _children(tree) -> list[tuple[str, Any]] | None:
    """(key string, child) of a container in ``jax``'s order, or None for
    a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def leaves_with_paths(tree) -> list[tuple[str, Any]]:
    """Every leaf with its path, in ``jax``'s flattening order."""
    kids = _children(tree)
    if kids is None:
        return [("", tree)]
    out = []
    for key, child in kids:
        out += [(key + ("/" + p if p else ""), leaf) for p, leaf in leaves_with_paths(child)]
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like, new_leaves) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` in
    :func:`leaves` order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}  # leaves come in sorted key order
            return {k: built[k] for k in t}  # the caller's key order kept
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(x, *(o[i] for o in others)) for i, x in enumerate(leaves(tree))])


def value_and_grad(fn: Callable) -> Callable:
    """``jax.value_and_grad`` of a scalar function of a tree of tensors:
    ``value_and_grad(fn)(params)`` is (the detached value, a tree of
    ``params``' structure holding each leaf's gradient in its dtype, zeros
    where the value does not depend on it).  The leaves are detached
    aliases that require a gradient, so ``params`` is not changed and no
    tensor is copied."""

    def wrapped(params):
        live = [leaf.detach().requires_grad_() for leaf in leaves(params)]
        with torch.enable_grad():
            value = fn(unflatten(params, live))
            grads = torch.autograd.grad(value, live, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, live)]
        return value.detach(), unflatten(params, grads)

    return wrapped
