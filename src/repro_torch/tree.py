"""Nested dicts of tensors, walked in JAX's order.

``jax.tree_util`` flattens a dict in sorted-key order, whatever order its
keys were inserted in.  Whatever depends on leaf order must agree with
repro: the gradient buckets of ``optim/compression.py`` (and with them the
int8 scales) and the checkpoint's key list.  So every walk here sorts the
keys at each level, as JAX does."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

Tree = Dict[str, Any]
Path = Tuple[str, ...]


def flatten(tree: Tree, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """[(path, leaf)] in JAX's flatten order."""
    out: List[Tuple[Path, Any]] = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += flatten(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def leaves(tree: Tree) -> List[Any]:
    return [v for _, v in flatten(tree)]


def unflatten(pairs: List[Tuple[Path, Any]]) -> Tree:
    out: Tree = {}
    for path, leaf in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn: Callable[..., Any], tree: Tree, *rest: Tree) -> Tree:
    """fn over matching leaves of trees with the same keys."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def key(path: Path) -> str:
    """The checkpoint's name of a leaf, e.g. ``params/layers/attn/wq``."""
    return "/".join(path)
