"""Parameter trees, their fan-in initializer, and the flat layout.

Parameters are nested dicts (and lists) of tensors, as in ``repro``.
``FlatLayout`` maps such a tree onto one flat vector and back: the round
engine keeps a whole cohort as ONE (C, M) buffer whose rows are clients,
so the local optimizer step and the fusion each run as one pass over it
(the counterpart of ``jax.flatten_util.ravel_pytree`` in the reference's
kernel route). Leaves sit in the order of ``tree_paths``: dict keys
sorted, lists in index order, as jax flattens them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

Params = Any


@dataclasses.dataclass(frozen=True)
class Initializer:
    """Fan-in scaled normal initializer: N(0, 1) * scale / sqrt(fan_in),
    drawn from an explicit ``torch.Generator`` on the generator's device
    (the CNNs draw on the CPU and callers move the tree; a full-width LM
    draws on the card)."""
    scale: float = 1.0

    def __call__(self, generator: torch.Generator, shape, fan_in=None,
                 dtype=torch.float32) -> torch.Tensor:
        fan_in = fan_in if fan_in is not None else shape[0]
        std = self.scale / math.sqrt(max(fan_in, 1))
        return torch.randn(tuple(shape), generator=generator, dtype=dtype,
                           device=generator.device) * std


default_init = Initializer()


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------


def _children(node):
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def tree_paths(tree) -> list[tuple]:
    """Paths (tuples of keys/indices) of every leaf, in flattening order.
    A leaf is anything that is not a dict, list or tuple (None too)."""
    out = []

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            out.append(path)
            return
        for k, child in kids:
            walk(child, path + (k,))

    walk(tree, ())
    return out


def tree_get(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def tree_leaves(tree) -> list:
    return [tree_get(tree, p) for p in tree_paths(tree)]


def tree_unflatten(like, leaves) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` in flattening
    order (``tree_leaves`` inverted)."""
    return _rebuild(like, (), dict(zip(tree_paths(like), leaves)))


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leafwise over trees of one structure."""
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    out = [tree_map(fn, v, *(r[i] for r in rest))
           for i, v in enumerate(tree)]
    return type(tree)(out)


def key_path(path: tuple) -> str:
    """A leaf's path as the JAX package names it in a checkpoint: the
    keys of ``jax.tree_util.tree_flatten_with_path`` joined by ``/``,
    dict keys as ``['name']`` and list or tuple indices as ``[0]``."""
    return "/".join(f"[{k!r}]" for k in path)


def tree_leaves_with_path(tree) -> list[tuple[str, Any]]:
    """(``key_path``, leaf) of every leaf in flattening order. None is
    an empty subtree, as in jax, and yields nothing."""
    return [(key_path(p), leaf) for p in tree_paths(tree)
            if (leaf := tree_get(tree, p)) is not None]


def tree_map_with_path(fn: Callable, tree, _path: tuple = ()):
    """``fn(key_path, leaf)`` applied leafwise (None passes through)."""
    kids = _children(tree)
    if kids is None:
        return None if tree is None else fn(key_path(_path), tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, _path + (k,))
                for k, v in tree.items()}
    return type(tree)(tree_map_with_path(fn, v, _path + (i,))
                      for i, v in enumerate(tree))


def stack_init(init_fn: Callable[..., Params], generator: torch.Generator,
               n: int, *args, **kwargs) -> Params:
    """``n`` copies of a layer, stacked on a leading layer axis (the
    reference's layout, which it applies with ``lax.scan``; the port
    loops over the layers in Python)."""
    layers = [init_fn(generator, *args, **kwargs) for _ in range(n)]
    return tree_map(lambda *leaves: torch.stack(leaves), *layers)


def rematerialized(fn: Callable, *args):
    """``fn(*args)``, its activations recomputed in the backward pass
    rather than kept (the reference's ``jax.checkpoint``): through
    ``torch.utils.checkpoint`` (non-reentrant) when plain autograd
    records the call. Under a ``torch.func`` transform (the round
    engine's ``vmap(grad(...))``), which refuses checkpoint's saved-
    tensor hooks, and under ``no_grad``, ``fn`` runs as it is. Remat
    moves memory, not numbers: both routes compute the same values."""
    if (not torch.is_grad_enabled()
            or torch._C._functorch.peek_interpreter_stack() is not None):
        return fn(*args)
    from torch.utils.checkpoint import checkpoint
    return checkpoint(fn, *args, use_reentrant=False)


def param_count(params: Params) -> int:
    return sum(int(p.numel()) for p in tree_leaves(params))


# ---------------------------------------------------------------------------
# Flat layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Slot:
    """One leaf's place in the flat vector."""
    path: tuple
    shape: tuple
    offset: int

    @property
    def size(self) -> int:
        return math.prod(self.shape)


# Row stride of cohort buffers, in elements: a multiple of 64 starts every
# row of a stacked (C, M) buffer on a 16-byte boundary (256 bytes at
# fp32, 128 at bf16), which the kernels' 16-byte vector loads need.
_ROW_ALIGN = 64


class FlatLayout:
    """Leaf slots of one parameter tree in a flat (M,) vector.

    ``stride`` is M rounded up to ``_ROW_ALIGN`` elements: buffers made
    by ``alloc`` have that row stride, so every row of a stacked (C, M)
    buffer starts 16-byte aligned and the buffer is the (C, M) view of a
    (C, stride) allocation."""

    def __init__(self, tree: Params):
        self._skeleton = tree_map(lambda _: None, tree)
        slots, off = [], 0
        for path in tree_paths(tree):
            shape = tuple(tree_get(tree, path).shape)
            slots.append(Slot(path, shape, off))
            off += math.prod(shape)
        self.slots = tuple(slots)
        self.size = off
        self.stride = -(-off // _ROW_ALIGN) * _ROW_ALIGN

    def alloc(self, lead: tuple = (), *, device=None,
              dtype=torch.float32) -> torch.Tensor:
        """A zeroed (*lead, M) buffer of row stride ``self.stride``."""
        buf = torch.zeros(tuple(lead) + (self.stride,), device=device,
                          dtype=dtype)
        return buf[..., :self.size]

    def flatten(self, tree: Params, out: torch.Tensor | None = None,
                *, device=None) -> torch.Tensor:
        """Copy a tree (leaves (*lead, *shape)) into a (*lead, M) buffer,
        by default one of the first leaf's dtype. Every leaf must have
        the buffer's dtype: a copy into another would round it (a bf16
        buffer rounds an fp32 leaf) with no trace in the result."""
        first = tree_get(tree, self.slots[0].path)
        lead = tuple(first.shape[:first.dim() - len(self.slots[0].shape)])
        if out is None:
            out = self.alloc(lead, device=device or first.device,
                             dtype=first.dtype)
        stray = sorted({str(leaf.dtype) for leaf in self.leaves(tree)}
                       - {str(out.dtype)})
        if stray:
            raise ValueError(
                f"FlatLayout.flatten: leaves of dtype {', '.join(stray)} "
                f"into a {out.dtype} buffer; a flat buffer holds one "
                "dtype, so give the tree one")
        for s in self.slots:
            leaf = tree_get(tree, s.path)
            out[..., s.offset:s.offset + s.size].copy_(
                leaf.reshape(lead + (s.size,)))
        return out

    def unflatten(self, flat: torch.Tensor) -> Params:
        """The tree of views into ``flat`` (*lead, M) -> leaves
        (*lead, *shape). One ``split`` makes every piece, so a gradient
        taken through the views comes back as one flat (M,) vector."""
        lead = tuple(flat.shape[:-1])
        pieces = torch.split(flat, [s.size for s in self.slots], dim=-1)
        by_path = {s.path: p.reshape(lead + s.shape)
                   for s, p in zip(self.slots, pieces)}
        return _rebuild(self._skeleton, (), by_path)

    def leaves(self, tree: Params) -> list:
        """The values of a tree of this structure (e.g. a group-axis
        tree), one per slot."""
        return [tree_get(tree, s.path) for s in self.slots]


def _rebuild(node, path, by_path):
    kids = _children(node)
    if kids is None:
        return by_path[path]
    if isinstance(node, dict):
        return {k: _rebuild(v, path + (k,), by_path) for k, v in kids}
    return type(node)(_rebuild(v, path + (i,), by_path) for i, v in kids)
