"""Nests of parameters: dicts, lists, tuples and named tuples whose
leaves are tensors (or numpy arrays), with ``None`` as an empty subtree
(an optimizer state without momentum). The port's stand-in for the
parts of ``jax.tree_util`` that the JAX package uses."""

from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to one nest, or to several nests of the
    same structure; ``None`` subtrees stay ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        parts = [tree_map(fn, *vs) for vs in zip(tree, *rest)]
        if hasattr(tree, "_fields"):             # a named tuple
            return type(tree)(*parts)
        return type(tree)(parts)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a nest, in ``tree_map``'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_flatten_with_path(tree, path=()) -> list:
    """[(path, leaf)] in ``tree_map``'s order. A leaf's path is the tuple
    of the dict keys, sequence indices and named-tuple field names that
    lead to it, as ``jax.tree_util.tree_flatten_with_path`` names them;
    ``None`` subtrees have no leaves. (A walk of its own: ``tree_map``
    runs on every training step and stays free of path bookkeeping.)"""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = zip(getattr(tree, "_fields", range(len(tree))), tree)
    else:
        return [(path, tree)]
    return [pair for key, sub in items
            for pair in tree_flatten_with_path(sub, path + (key,))]


def tree_unflatten(like, leaves):
    """A nest shaped like ``like`` whose leaves are ``leaves``, in
    ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def stack_workers(tree, n_workers: int):
    """Every tensor leaf repeated along a new leading worker dim:
    ``[...]`` -> ``[n_workers, ...]``, contiguous (the kernels take
    contiguous operands). Worker ``w``'s slice of each leaf equals the
    leaf."""
    return tree_map(lambda t: t.unsqueeze(0).expand(
        (n_workers,) + tuple(t.shape)).contiguous(), tree)
