"""Per-neuron activation x gradient reduction: Eq. 9's hot loop.

Replaces the TPU kernel ``feature_stats_kernel`` of
``src/repro/kernels/feature_stats.py`` together with its wrapper
(``repro/kernels/ops.py:feature_stats``) and oracle
(``repro/kernels/ref.py:feature_stats_ref``): ``p[i] = sum_b a[b, i] *
g[b, i]`` over two (B, I) matrices, accumulated and returned in fp32.
The kernel is CUDA C++ for Hopper in ``csrc/feature_stats.cu``, built by
``kernels/build.py`` and bound with ctypes.

Bound on the H100: bytes (2*B*I values read once, I floats written, two
flops per value pair). The TPU kernel walks B as a sequential grid axis
into a VMEM accumulator on tiles padded to 256 x 512, one call per pair.
One pair per launch is launch-bound on the card at Eq. 9's shapes (B =
64, I <= 512), so the CUDA kernel takes a table of segments, each S
instances of one (B, I) shape, and reduces all of them in one launch:
``feature_stats_many`` is that call, and Eq. 9 makes one per evaluation
(``core/feature_stats.py``). A block owns 256 bytes of a row's columns
of one instance (16-byte loads where alignment allows) and walks its
rows; nothing is padded. ``feature_stats`` is the single-pair call: one
segment, or, for long columns, rows split over blocks into a workspace
that a second pass sums in a fixed order.

On CPU tensors both wrappers compute their plain versions
(``feature_stats_ref``, ``feature_stats_many_ref``); on CUDA tensors they
launch the kernel or raise. ``feature_stats.launches`` counts kernel
launches: one per ``feature_stats`` call, one per table of up to
``feature_stats_table_capacity()`` segments in ``feature_stats_many``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def feature_stats_ref(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain version: (B, I), (B, I) -> (I,) = sum_b a*g in fp32."""
    return (a.float() * g.float()).sum(0)


def feature_stats_many_ref(a_list, g_list, outs=None) -> list:
    """The plain version of ``feature_stats_many``: for each (S, B, I)
    pair, the (I, S) fp32 ``out[i, s] = sum_b a[s, b, i] * g[s, b, i]``,
    written into ``outs`` where given."""
    got = [(a.float() * g.float()).sum(1).t() for a, g in zip(a_list, g_list)]
    if outs is None:
        return got
    for out, p in zip(outs, got):
        out.copy_(p)
    return list(outs)


def _library() -> ctypes.CDLL:
    lib = build.load("feature_stats")
    lib.feature_stats_splits.argtypes = [ctypes.c_longlong,
                                         ctypes.c_longlong, ctypes.c_int]
    lib.feature_stats_splits.restype = ctypes.c_int
    fn = lib.feature_stats_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.feature_stats_table_capacity.argtypes = []
    lib.feature_stats_table_capacity.restype = ctypes.c_int
    many = lib.feature_stats_many_launch
    many.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                     ctypes.c_int, ctypes.c_void_p]
    many.restype = ctypes.c_int
    return lib


def _check(a, g):
    if a.dim() != 2 or a.shape != g.shape:
        raise ValueError(
            f"feature_stats takes two (B, I) matrices of one shape, got "
            f"{tuple(a.shape)} and {tuple(g.shape)}")
    if a.shape[0] < 1 or a.shape[1] < 1:
        raise ValueError(f"feature_stats takes a non-empty (B, I), got "
                         f"{tuple(a.shape)}")
    if a.dtype not in _DTYPE_CODES or g.dtype != a.dtype:
        raise TypeError(
            f"feature_stats takes float32 or bfloat16 inputs of one "
            f"dtype, got {a.dtype} and {g.dtype}")
    if g.device != a.device:
        raise ValueError("feature_stats: a and g must share a device")
    if not (a.is_contiguous() and g.is_contiguous()):
        raise ValueError("feature_stats needs contiguous (row-major) "
                         "inputs")


def _check_many(a_list, g_list, outs):
    if len(a_list) < 1 or len(a_list) != len(g_list):
        raise ValueError(
            f"feature_stats_many takes one or more (a, g) pairs, got "
            f"{len(a_list)} a and {len(g_list)} g")
    dtype, device = a_list[0].dtype, a_list[0].device
    for k, (a, g) in enumerate(zip(a_list, g_list)):
        if a.dim() != 3 or a.shape != g.shape:
            raise ValueError(
                f"feature_stats_many: pair {k} is not two (S, B, I) "
                f"tensors of one shape: {tuple(a.shape)} and "
                f"{tuple(g.shape)}")
        if min(a.shape) < 1:
            raise ValueError(f"feature_stats_many: pair {k} is empty: "
                             f"{tuple(a.shape)}")
        if a.dtype not in _DTYPE_CODES or (a.dtype, g.dtype) != (dtype,
                                                                 dtype):
            raise TypeError(
                f"feature_stats_many takes float32 or bfloat16 inputs of "
                f"one dtype, got {dtype} and, in pair {k}, {a.dtype} and "
                f"{g.dtype}")
        if a.device != device or g.device != device:
            raise ValueError("feature_stats_many: all pairs must share a "
                             "device")
        if not (a.is_contiguous() and g.is_contiguous()):
            raise ValueError(f"feature_stats_many needs contiguous "
                             f"inputs (pair {k})")
    if outs is None:
        return
    if len(outs) != len(a_list):
        raise ValueError(f"feature_stats_many: {len(outs)} outs for "
                         f"{len(a_list)} pairs")
    for k, (out, a) in enumerate(zip(outs, a_list)):
        want = (a.shape[2], a.shape[0])
        if (tuple(out.shape) != want or out.dtype != torch.float32
                or out.device != device):
            raise ValueError(
                f"feature_stats_many: out {k} must be an (I, S) = {want} "
                f"float32 tensor on {device}, got {tuple(out.shape)} "
                f"{out.dtype} on {out.device}")
        if any(st == 0 and n > 1 for st, n in zip(out.stride(), want)):
            raise ValueError(f"feature_stats_many: out {k} overlaps "
                             f"itself (stride 0)")


def feature_stats(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``sum_b a[b, i] * g[b, i]`` as an (I,) float32 tensor. CPU tensors
    take ``feature_stats_ref``; CUDA tensors launch the kernel."""
    _check(a, g)
    if a.device.type == "cpu":
        return feature_stats_ref(a, g)
    if a.device.type != "cuda":
        raise ValueError(f"feature_stats: unsupported device {a.device}")
    b, i = a.shape
    code = _DTYPE_CODES[a.dtype]
    lib = _library()
    out = torch.empty(i, dtype=torch.float32, device=a.device)
    splits = lib.feature_stats_splits(b, i, code)
    ws = (torch.empty((splits, i), dtype=torch.float32, device=a.device)
          if splits > 1 else None)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.feature_stats_launch(
            a.data_ptr(), g.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), b, i, splits, code,
            stream)
    if err != 0:
        raise RuntimeError(f"feature_stats kernel launch failed: CUDA "
                           f"error {err}")
    feature_stats.launches += 1
    return out


feature_stats.launches = 0


def feature_stats_table_capacity() -> int:
    """Segments one launch of ``feature_stats_many`` takes."""
    return _library().feature_stats_table_capacity()


def feature_stats_many(a_list, g_list, outs=None) -> list:
    """Many ``feature_stats`` reductions in one launch: pair k is two
    contiguous (S_k, B_k, I_k) tensors (fp32 or bf16, one dtype and device
    for all), and its result the (I_k, S_k) float32 ``out[i, s] = sum_b
    a[s, b, i] * g[s, b, i]``, written into ``outs[k]`` (any strides)
    where given, else into a new tensor. Returns the outputs. CPU tensors
    take ``feature_stats_many_ref``; CUDA tensors launch the kernel, once
    per ``feature_stats_table_capacity()`` pairs."""
    _check_many(a_list, g_list, outs)
    device = a_list[0].device
    if device.type == "cpu":
        return feature_stats_many_ref(a_list, g_list, outs)
    if device.type != "cuda":
        raise ValueError(f"feature_stats_many: unsupported device {device}")
    code = _DTYPE_CODES[a_list[0].dtype]
    lib = _library()
    if outs is None:
        outs = [torch.empty((a.shape[2], a.shape[0]), dtype=torch.float32,
                            device=device) for a in a_list]
    rows = [(a.data_ptr(), g.data_ptr(), out.data_ptr(), *a.shape,
             *out.stride()) for a, g, out in zip(a_list, g_list, outs)]
    cap = lib.feature_stats_table_capacity()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for start in range(0, len(rows), cap):
            chunk = rows[start:start + cap]
            table = (ctypes.c_longlong * (8 * len(chunk)))(
                *[v for row in chunk for v in row])
            err = lib.feature_stats_many_launch(table, len(chunk), code,
                                                stream)
            if err != 0:
                raise RuntimeError(f"feature_stats_many kernel launch "
                                   f"failed: CUDA error {err}")
            feature_stats.launches += 1
    return list(outs)
