"""Parameter trees: nested dicts whose leaves are tensors, QTensors or None.

Paths are spelled as ``jax.tree_util.keystr`` spells them
(``['decoder']['layers']['attn']['wq']``, a QTensor's children as
``...['wq'].data``), so a path names the same leaf in both packages.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple

from .core.qtensor import QTensor

__all__ = ["keystr", "leaves_with_path", "flat_leaves", "map_like"]


def keystr(keys: Tuple[str, ...]) -> str:
    return "".join(f"[{k!r}]" for k in keys)


def leaves_with_path(tree: Any, keys: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(keys, leaf) for every non-dict node, dicts walked in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_path(v, keys + (k,))
    else:
        yield keys, tree


def flat_leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, tensor) of every tensor in JAX's flattening order (dict keys
    sorted): a QTensor's children as ``path.child``; None leaves and None
    children dropped."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat_leaves(tree[k], path + keystr((k,)))
    elif isinstance(tree, QTensor):
        for name in QTensor._CHILDREN:
            if getattr(tree, name) is not None:
                yield f"{path}.{name}", getattr(tree, name)
    elif tree is not None:
        yield path, tree


def map_like(fn: Callable, tree: Any, *others: Any) -> Any:
    """``fn(leaf, *others' nodes at the same path)`` over ``tree``'s dict
    structure; the nodes of ``others`` there may be subtrees (an 8-bit
    moment's ``{codes, scale}``) and pass whole."""
    if isinstance(tree, dict):
        return {k: map_like(fn, v, *(o[k] for o in others)) for k, v in tree.items()}
    return fn(tree, *others)
