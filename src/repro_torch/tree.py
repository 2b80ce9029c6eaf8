"""Trees of tensors: nested dicts, tuples and NamedTuples, walked in JAX's
order (dict keys sorted, sequences by index, NamedTuple fields in order),
so a leaf list, or a leaf's path name, is the same in both packages."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> List[Tuple[str, Any]]:
    """(path part, child) pairs of one node, or [] for a leaf. The parts
    are the names JAX's key path gives: a dict key, a sequence index, and
    ``.field`` for a NamedTuple field (its ``GetAttrKey``)."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return []


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, tuple, list))


def leaves(tree) -> List[Any]:
    if not _is_node(tree):
        return [tree]
    return [x for _, c in _children(tree) for x in leaves(c)]


def named_leaves(tree) -> Dict[str, Any]:
    """{"a/b/.field/0": leaf, ...} in leaf order: the names the reference's
    checkpoint manager writes (``_flatten_with_names``)."""
    out: Dict[str, Any] = {}

    def walk(node, prefix):
        if not _is_node(node):
            out[prefix] = node
            return
        for part, child in _children(node):
            walk(child, f"{prefix}/{part}" if prefix else part)

    walk(tree, "")
    return out


def map_tree(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure, keeping
    the first tree's containers. Leaves are visited in ``leaves`` order,
    so ``fn`` may consume an iterator over another tree's leaves."""
    if not _is_node(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        out = {k: map_tree(fn, tree[k], *(r[k] for r in rest))
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    kids = [map_tree(fn, x, *(r[i] for r in rest))
            for i, x in enumerate(tree)]
    if _is_namedtuple(tree):
        return type(tree)(*kids)
    return type(tree)(kids)
