"""Parameter trees, their fan-in initializer, and the flat layout.

Parameters are nested dicts (and lists) of tensors, as in ``repro``.
``FlatLayout`` maps such a tree onto flat vectors and back, one per leaf
dtype: the round engine keeps a whole cohort as one (C, M_d) buffer per
dtype whose rows are clients (ONE (C, M) buffer for a tree of one
dtype), so the local optimizer step and the fusion each run as one pass
over each buffer. ``FlatLayout.ravel`` is the counterpart of
``jax.flatten_util.ravel_pytree`` in the reference's kernel route: one
buffer of the whole tree. Leaves sit in the order of ``tree_paths``:
dict keys sorted, lists in index order, as jax flattens them.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch
import torch.utils._pytree as torch_pytree

Params = Any

# the device that init code draws on inside ``drawing_on``
_DRAW_DEVICE = contextvars.ContextVar("draw_device", default=None)


def draw_device(generator: torch.Generator) -> torch.device:
    """Where init code puts what it draws from ``generator``: the device
    of the innermost ``drawing_on``, else the generator's own."""
    return _DRAW_DEVICE.get() or generator.device


@contextlib.contextmanager
def drawing_on(device):
    """Init code inside draws on ``device`` whatever its generator's
    device (None: the generator's). ``torch.Generator`` cannot live on
    ``meta``, but a CPU generator can draw onto it: a tree of the full
    236 B DeepSeek then allocates nothing."""
    token = _DRAW_DEVICE.set(None if device is None
                             else torch.device(device))
    try:
        yield
    finally:
        _DRAW_DEVICE.reset(token)


@dataclasses.dataclass(frozen=True)
class Initializer:
    """Fan-in scaled normal initializer: N(0, 1) * scale / sqrt(fan_in),
    drawn from an explicit ``torch.Generator`` on ``draw_device`` (the
    CNNs draw on the CPU and callers move the tree; a full-width LM
    draws on the card; a shape-only tree on ``meta``)."""
    scale: float = 1.0

    def __call__(self, generator: torch.Generator, shape, fan_in=None,
                 dtype=torch.float32) -> torch.Tensor:
        device = draw_device(generator)
        if device.type == "meta":            # shapes only: nothing to draw
            return torch.empty(tuple(shape), dtype=dtype, device=device)
        fan_in = fan_in if fan_in is not None else shape[0]
        std = self.scale / math.sqrt(max(fan_in, 1))
        return torch.randn(tuple(shape), generator=generator, dtype=dtype,
                           device=device) * std


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


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable | None = None):
    """``fn`` applied leafwise over trees of one structure; a node for
    which ``is_leaf`` holds counts as a leaf."""
    kids = None if is_leaf is not None and is_leaf(tree) else \
        _children(tree)
    if kids is None:
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    out = [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
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
    loops over the layers in Python). Each layer is drawn in turn and
    copied into the stack, so the peak is the stack and one layer (a
    full-width MoE layer is 5-8 GB)."""
    stack = None
    for i in range(n):
        layer = init_fn(generator, *args, **kwargs)
        if stack is None:
            stack = tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)),
                             layer)
        tree_map(lambda s, t: s[i].copy_(t), stack, layer)
        del layer
    return stack


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
    """One leaf's place in the flat vector: ``offset`` into the buffer of
    its dtype's segment (``segment``)."""
    path: tuple
    shape: tuple
    offset: int
    dtype: torch.dtype = torch.float32
    segment: int = 0

    @property
    def size(self) -> int:
        return math.prod(self.shape)


# Row stride of cohort buffers, in elements: a multiple of 64 starts every
# row of a stacked (C, M) buffer on a 16-byte boundary (256 bytes at
# fp32, 128 at bf16), which the kernels' 16-byte vector loads need.
_ROW_ALIGN = 64


def _stride(size: int) -> int:
    return -(-size // _ROW_ALIGN) * _ROW_ALIGN


@dataclasses.dataclass(frozen=True)
class Segment:
    """The slots of one dtype, in tree order: a (*lead, size) buffer of
    row stride ``stride``."""
    dtype: torch.dtype
    slots: tuple
    size: int

    @property
    def stride(self) -> int:
        return _stride(self.size)


class Segments(tuple):
    """A flat value of a tree that mixes dtypes: one tensor per dtype
    segment of its ``FlatLayout``, in segment order. The port's tree
    functions (``tree_map``, ``tree_leaves``) and ``torch.func``'s see
    it as a node, so elementwise code runs segment by segment."""
    __slots__ = ()


torch_pytree.register_pytree_node(
    Segments, lambda s: (list(s), None), lambda parts, _: Segments(parts))


def flat_parts(flat) -> tuple:
    """The per-segment arrays of a flat value: the parts of ``Segments``
    (or of a tuple or list of them), else ``(flat,)``."""
    return tuple(flat) if isinstance(flat, (tuple, list)) else (flat,)


def host(x):
    """A tensor as host numpy, or as a CPU tensor where numpy has no
    such dtype (bfloat16); anything else as numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def dtype_names(dtypes) -> str:
    return ", ".join(sorted(str(d).replace("torch.", "") for d in dtypes))


class FlatLayout:
    """Leaf slots of one parameter tree in flat vectors, one per dtype.

    The slots are grouped into SEGMENTS, one per leaf dtype, ordered by
    where each dtype's first leaf sits in tree order; within a segment
    the slots keep tree order. A flat value of the layout is one tensor
    (*lead, M_d) per segment: the tensor itself when the tree has one
    dtype, else ``Segments``. Each segment's buffers made by ``alloc``
    have row stride ``stride`` (M_d rounded up to ``_ROW_ALIGN``
    elements), so every row of a stacked (C, M_d) buffer starts 16-byte
    aligned and the buffer is the (C, M_d) view of a (C, stride)
    allocation.

    ``size`` and ``stride`` are those of the whole tree, all segments
    together (one segment's when the tree has one dtype). ``ravel`` and
    ``unravel`` map a flat value onto ONE buffer of every leaf in tree
    order and back (``jax.flatten_util.ravel_pytree``: for a tree that
    mixes dtypes its buffer takes the promoted dtype, fp32 for bf16 and
    fp32 leaves). ``by_dtype=False`` builds that one-buffer layout."""

    def __init__(self, tree: Params, *, by_dtype: bool = True):
        self._skeleton = tree_map(lambda _: None, tree)
        leaves = [(path, tree_get(tree, path)) for path in tree_paths(tree)]
        dtypes = list(dict.fromkeys(leaf.dtype for _, leaf in leaves))
        if not by_dtype:
            one = dtypes[0]
            for d in dtypes[1:]:
                one = torch.promote_types(one, d)
            dtypes = [one]
        slots, sizes = [], [0] * len(dtypes)
        for path, leaf in leaves:
            seg = dtypes.index(leaf.dtype) if by_dtype else 0
            slots.append(Slot(path, tuple(leaf.shape), sizes[seg],
                              leaf.dtype, seg))
            sizes[seg] += math.prod(leaf.shape)
        self.slots = tuple(slots)
        self.segments = tuple(
            Segment(d, tuple(s for s in slots if s.segment == i), sizes[i])
            for i, d in enumerate(dtypes))
        self.size = sum(sizes)
        self.stride = _stride(self.size)
        # the shapes and dtypes of a mixed tree, for its raveled layout
        self._meta = (None if len(self.segments) == 1 else tree_map(
            lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
            tree))
        self._raveled = self._run_list = None

    @property
    def dtypes(self) -> tuple:
        return tuple(seg.dtype for seg in self.segments)

    def require_one_dtype(self, what: str) -> None:
        """Raise ValueError when the tree mixes dtypes: ``what`` (an axis
        of the round) has no per-dtype form yet."""
        if len(self.segments) > 1:
            raise ValueError(
                f"{what}: a params tree that mixes dtypes "
                f"({dtype_names(self.dtypes)}) is not supported; this "
                "works on one flat buffer of one dtype, and the round "
                "keeps each dtype in a buffer of its own")

    def join(self, parts):
        """A flat value from its per-segment tensors."""
        parts = tuple(parts)
        return parts[0] if len(parts) == 1 else Segments(parts)

    def alloc(self, lead: tuple = (), *, device=None, dtype=None):
        """A zeroed (*lead, M_d) buffer per segment, of row stride
        ``stride``, in the segment's dtype (or every one in ``dtype``)."""
        return self.join(
            torch.zeros(tuple(lead) + (seg.stride,), device=device,
                        dtype=dtype or seg.dtype)[..., :seg.size]
            for seg in self.segments)

    def flatten(self, tree: Params, out=None, *, device=None):
        """Copy a tree (leaves (*lead, *shape)) into a flat value
        (*lead, M_d) per segment, by default of the segments' dtypes
        (one dtype: the first leaf's). Every leaf must have its buffer's
        dtype: a copy into another would round it (a bf16 buffer rounds
        an fp32 leaf) with no trace in the result."""
        first = tree_get(tree, self.slots[0].path)
        lead = tuple(first.shape[:first.dim() - len(self.slots[0].shape)])
        if out is None:
            out = self.alloc(lead, device=device or first.device,
                             dtype=(first.dtype if len(self.segments) == 1
                                    else None))
        parts = flat_parts(out)
        stray = sorted({str(leaf.dtype) for s, leaf
                        in zip(self.slots, self.leaves(tree))
                        if leaf.dtype != parts[s.segment].dtype})
        if stray:
            raise ValueError(
                f"FlatLayout.flatten: leaves of dtype {', '.join(stray)} "
                f"into a buffer of another dtype "
                f"({dtype_names({p.dtype for p in parts})}); each buffer "
                "holds its leaves' one dtype")
        for s in self.slots:
            leaf = tree_get(tree, s.path)
            parts[s.segment][..., s.offset:s.offset + s.size].copy_(
                leaf.reshape(lead + (s.size,)))
        return out

    def unflatten(self, flat) -> Params:
        """The tree of views into a flat value (*lead, M_d) per segment ->
        leaves (*lead, *shape). One ``split`` per segment makes every
        piece, so a gradient taken through the views comes back as one
        flat (M_d,) vector per segment."""
        by_path = {}
        for seg, part in zip(self.segments, flat_parts(flat)):
            lead = tuple(part.shape[:-1])
            pieces = torch.split(part, [s.size for s in seg.slots], dim=-1)
            by_path.update((s.path, p.reshape(lead + s.shape))
                           for s, p in zip(seg.slots, pieces))
        return _rebuild(self._skeleton, (), by_path)

    def leaves(self, tree: Params) -> list:
        """The values of a tree of this structure (e.g. a group-axis
        tree), one per slot."""
        return [tree_get(tree, s.path) for s in self.slots]

    def cast(self, tree: Params) -> Params:
        """A tree of this structure with every leaf in its slot's dtype."""
        by_path = {s.path: tree_get(tree, s.path).to(s.dtype)
                   for s in self.slots}
        return _rebuild(self._skeleton, (), by_path)

    # -- one buffer of the whole tree (ravel_pytree's) ----------------------

    @property
    def raveled(self) -> "FlatLayout":
        """The layout of ONE buffer of every leaf in tree order, of the
        promoted dtype: this layout itself when the tree has one dtype."""
        if self._raveled is None:
            self._raveled = (self if self._meta is None else
                             FlatLayout(self._meta, by_dtype=False))
        return self._raveled

    def _runs(self) -> list:
        """(segment, offset in it, offset in the raveled buffer, size) of
        each run of consecutive slots of one segment, in tree order."""
        if self._run_list is None:
            runs = []
            for s, r in zip(self.slots, self.raveled.slots):
                if runs and runs[-1][0] == s.segment and \
                        runs[-1][1] + runs[-1][3] == s.offset:
                    runs[-1][3] += s.size
                else:
                    runs.append([s.segment, s.offset, r.offset, s.size])
            self._run_list = [tuple(r) for r in runs]
        return self._run_list

    def pieces(self, x) -> list:
        """How ``x`` lies over the segments: (view, segment, offset) for
        each stretch of it whose leaves are consecutive in one segment,
        ``view`` (*lead, n) holding that segment's elements [offset,
        offset + n). A flat value gives one piece per segment; a raveled
        buffer of a tree that mixes dtypes (one tensor of ``raveled``'s
        size, e.g. the bf16 local phase's shadow) one per run of slots
        (``ravel``'s order)."""
        if self.raveled is self or not isinstance(x, torch.Tensor):
            return [(p, i, 0) for i, p in enumerate(flat_parts(x))]
        return [(x[..., b:b + n], seg, a) for seg, a, b, n in self._runs()]

    def slots_in(self, segment: int, offset: int, n: int) -> list:
        """(index in ``slots``, offset from ``offset``, size) of each slot
        of ``segment`` inside its elements [offset, offset + n)."""
        return [(i, s.offset - offset, s.size)
                for i, s in enumerate(self.slots)
                if s.segment == segment and offset <= s.offset < offset + n]

    def ravel(self, flat, out=None):
        """A flat value copied into one raveled buffer (*lead, M) (``out``,
        else a new one), each leaf cast up exactly. One dtype: the value
        itself, no copy."""
        if self.raveled is self:
            return flat
        parts = flat_parts(flat)
        if out is None:
            out = self.raveled.alloc(tuple(parts[0].shape[:-1]),
                                     device=parts[0].device)
        for seg, a, b, n in self._runs():
            out[..., b:b + n].copy_(parts[seg][..., a:a + n])
        return out

    def unravel(self, raveled, out=None):
        """``ravel`` inverted: the flat value of a raveled buffer, each
        leaf cast to its dtype (rounded once). Into ``out``'s buffers, or,
        without ``out``, as new tensors through differentiable casts (the
        cast of ``ravel_pytree``'s ``unravel``: a loss taken through them
        gives an fp32 gradient of the raveled buffer). One dtype: the
        buffer itself."""
        if self.raveled is self:
            return raveled
        runs = self._runs()
        if out is not None:
            parts = flat_parts(out)
            for seg, a, b, n in runs:
                parts[seg][..., a:a + n].copy_(raveled[..., b:b + n])
            return out
        pieces = torch.split(raveled, [n for *_, n in runs], dim=-1)
        return Segments(
            torch.cat([p for r, p in zip(runs, pieces) if r[0] == i],
                      dim=-1).to(seg.dtype)
            for i, seg in enumerate(self.segments))


def _rebuild(node, path, by_path):
    kids = _children(node)
    if kids is None:
        return by_path[path]
    if isinstance(node, dict):
        return {k: _rebuild(v, path + (k,), by_path) for k, v in kids}
    return type(node)(_rebuild(v, path + (i,), by_path) for i, v in kids)
