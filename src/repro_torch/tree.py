"""Trees of tensors: nested dicts and lists, walked in the reference's
order.

JAX flattens a dict by its sorted keys and a list by index, depth first,
and names each leaf by ``jax.tree_util.keystr`` of its path, e.g.
``['prefix'][0]['input_norm']``.  The port's optimizer (global norm,
AdamW), checkpoints and compute cast walk its parameter trees (the LM's
``blocks["s{i}"]`` dicts and ``prefix`` / ``suffix`` lists, CapsuleNet's
flat dict) the same way, so sums run in the reference's order and
checkpoint keys are the reference's.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator


def leaves_with_keys(tree: Any, prefix: str = ""
                     ) -> Iterator[tuple[str, Any]]:
    """``(keystr, leaf)`` depth first: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_keys(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_keys(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def leaves(tree: Any) -> list:
    """The leaves of ``tree`` in the reference's order."""
    return [leaf for _, leaf in leaves_with_keys(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure): a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def leaves_with_path(tree: Any, prefix: tuple = ()
                     ) -> Iterator[tuple[tuple, Any]]:
    """``(path, leaf)`` in ``leaves_with_keys``' order, the path a tuple of
    dict keys (str) and list indices (int); a None subtree (a block that
    keeps no cache) has no leaves, as in the reference's pytrees."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, prefix + (i,))
    else:
        yield prefix, tree


def tree_map_with_path(fn: Callable, tree: Any, *rest: Any,
                       prefix: tuple = ()) -> Any:
    """``fn(path, leaf, *matching leaves of rest)`` over the leaves of
    ``tree``, paths as in ``leaves_with_path``; None subtrees stay None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      prefix=prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, v, *(r[i] for r in rest),
                                   prefix=prefix + (i,))
                for i, v in enumerate(tree)]
    return fn(prefix, tree, *rest)
