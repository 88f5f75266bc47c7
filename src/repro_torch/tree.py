"""Parameter trees: nested dicts (lists and tuples also walk) whose leaves
are tensors — the port's stand-in for JAX pytrees. A ``NamedTuple`` such as
:class:`repro_torch.optim.compression.Int8Weights` is one leaf."""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import torch


def _is_node(tree: Any) -> bool:
    return isinstance(tree, dict) or (
        isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"))


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over one tree or several of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_node(tree):
        return type(tree)(tree_map(fn, *vs) for vs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Any, *rest: Any,
                       path: Tuple = ()) -> Any:
    """``fn(path, leaf, *rest_leaves)`` leafwise, ``path`` the tuple of
    dict keys and list indices from the root (a JAX key path's entries)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=path + (k,))
                for k, v in tree.items()}
    if _is_node(tree):
        return type(tree)(tree_map_with_path(fn, *vs, path=path + (i,))
                          for i, vs in enumerate(zip(tree, *rest)))
    return fn(path, tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in a fixed order (dict keys sorted, as JAX orders them)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if _is_node(tree):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_structure(tree: Any) -> Any:
    """A hashable description of the tree's nesting (keys, not leaves)."""
    if isinstance(tree, dict):
        return tuple((k, tree_structure(tree[k])) for k in sorted(tree))
    if _is_node(tree):
        return (type(tree).__name__,
                tuple(tree_structure(v) for v in tree))
    return None


def stack_trees(trees: Sequence[Any]) -> Any:
    """Stack same-structured trees along a new leading axis."""
    return tree_map(lambda *ls: torch.stack(ls), *trees)


def stack_init(n: int, init: Callable[[], Any]) -> Any:
    """The trees of ``n`` calls of ``init()``, stacked along a new leading
    axis: the same values as ``stack_trees([init() for _ in range(n)])``,
    but each leaf is allocated once and every tree is copied in and dropped
    before the next is drawn, so the peak is the stack plus one tree (not
    two stacks). One tree is returned as a view, with no copy."""
    first = init()
    if n == 1:
        return tree_map(lambda t: t.unsqueeze(0), first)
    out = tree_map(lambda t: t.new_empty((n, *t.shape)), first)
    tree_map(lambda o, t: o[0].copy_(t), out, first)
    del first
    for i in range(1, n):
        tree_map(lambda o, t: o[i].copy_(t), out, init())
    return out


def trainable(tree: Any) -> Any:
    """A tree of new autograd leaves sharing the storage of ``tree``'s:
    every float leaf requires a gradient, the given tree is left as it is
    (a step differentiates these, then updates or replaces the originals)."""
    return tree_map(lambda t: t.detach().requires_grad_(t.is_floating_point()),
                    tree)


def tree_to(tree: Any, device: torch.device) -> Any:
    """Move every tensor leaf to ``device``."""
    return tree_map(
        lambda t: t.to(device) if isinstance(t, torch.Tensor) else t, tree)
