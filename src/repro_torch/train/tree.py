"""The few tree operations the training path needs, over the port's
parameter and optimizer-state trees: nested dicts, lists and tuples
(NamedTuples among them) with tensor leaves.

Leaves come in the JAX package's tree order (a dict's keys sorted, a
sequence's items and a NamedTuple's fields in order, ``None`` an empty
subtree), and :func:`paths` names each leaf as the JAX package's
checkpoints do: dict keys, sequence indices and NamedTuple field names
joined by ``/``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node: Any):
    """(name, child) pairs of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def paths(tree: Any, prefix: Tuple[str, ...] = ()
          ) -> Iterator[Tuple[str, Any]]:
    """``(key path, leaf)`` for every leaf, in tree order."""
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield "/".join(prefix), tree
        return
    for name, child in kids:
        yield from paths(child, prefix + (name,))


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in paths(tree)]


def unflatten(template: Any, new_leaves: List[Any]) -> Any:
    """``template``'s structure with its leaves replaced, in tree order,
    by ``new_leaves``."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}       # keep the key order
        if _is_namedtuple(node):
            return type(node)(*(build(c) for c in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(c) for c in node)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def map_leaves(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the same-shaped ``rest``."""
    return unflatten(tree, [fn(*xs) for xs in zip(
        leaves(tree), *(leaves(r) for r in rest))])
