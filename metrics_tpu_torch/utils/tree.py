"""Flatten state trees in the JAX package's leaf order.

``jax.tree_util`` flattens a dict in SORTED key order; ``torch.utils._pytree``
keeps insertion order. Every packing plan of the engine (arena column
offsets, megastep op rows, q8 column masks) must put the leaves where the JAX
package puts them, or spilled rows and bridged arenas scramble. So the port
flattens its state trees here: dicts by sorted key, lists and tuples in order,
anything else is a leaf.

:func:`spell_treedef` flattens as ``jax.tree_util`` does (``None`` is a node
with no leaves) and spells the ``repr`` of JAX's ``PyTreeDef``: the snapshot
digest and the arena fingerprint hash that string, so both must be JAX's,
character for character, for a snapshot to cross between the packages.
"""
from typing import Any, Callable, List, Tuple

__all__ = ["spell_treedef", "tree_flatten", "tree_leaves", "tree_map", "tree_unflatten"]

_LEAF = ("leaf",)


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``; ``treedef`` is a nested tuple whose ``repr``
    is stable, so it can be hashed into a fingerprint."""
    leaves: List[Any] = []

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", tuple(keys), tuple(walk(node[k]) for k in keys))
        if isinstance(node, (list, tuple)):
            return (type(node).__name__, len(node), tuple(walk(v) for v in node))
        leaves.append(node)
        return _LEAF

    treedef = walk(tree)
    return leaves, treedef


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_unflatten(treedef: Any, leaves: List[Any]) -> Any:
    """Inverse of :func:`tree_flatten`."""
    it = iter(leaves)

    def build(node: Any) -> Any:
        if node == _LEAF:
            return next(it)
        kind, meta, children = node
        if kind == "dict":
            return {k: build(c) for k, c in zip(meta, children)}
        out = [build(c) for c in children]
        return tuple(out) if kind == "tuple" else out

    return build(treedef)


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` applied to every leaf, the structure kept."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(leaf) for leaf in leaves])


def spell_treedef(tree: Any) -> Tuple[List[Any], str]:
    """``(leaves, spelled)``: the leaves in ``jax.tree_util.tree_flatten``'s
    order and ``repr`` of its treedef, e.g.
    ``PyTreeDef({'a': (*, *), 'b': [], 'd': None, 'e': [*]})``. Plain dicts
    (sorted keys), lists, tuples and ``None`` are nodes, anything else a leaf
    (``*``). A subclass of dict, list or tuple (``OrderedDict``, a
    namedtuple) is a node JAX spells by its own registration: it raises,
    naming the type."""
    leaves: List[Any] = []

    def walk(node: Any) -> str:
        if node is None:
            return "None"
        kind = type(node)
        if kind is dict:
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}" for k in sorted(node)) + "}"
        if kind is list:
            return "[" + ", ".join(walk(v) for v in node) + "]"
        if kind is tuple:
            inner = ", ".join(walk(v) for v in node)
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        if isinstance(node, (dict, list, tuple)):
            raise TypeError(f"cannot spell a tree node of type {kind.__module__}.{kind.__qualname__} "
                            "as the JAX package's treedef; use a plain dict, list or tuple")
        leaves.append(node)
        return "*"

    spelled = walk(tree)
    return leaves, f"PyTreeDef({spelled})"
