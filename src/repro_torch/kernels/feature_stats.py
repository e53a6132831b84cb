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
into a VMEM accumulator on tiles padded to 256 x 512; the CUDA kernel
pads nothing: each thread owns 4 fp32 (8 bf16) contiguous columns with
16-byte loads where alignment allows (else one column), loops over its
rows in registers, and adjacent threads read adjacent columns. Long
columns are also split over blocks into a workspace that a second pass
sums in a fixed order. At the Eq. 9 path's shapes (B = 64, I <= 512) a
call is one launch and launch-bound.

``feature_stats`` is the wrapper: on CPU tensors it computes
``feature_stats_ref``; on CUDA tensors it launches the kernel or raises.
``feature_stats.launches`` counts kernel launches (one per call).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def feature_stats_ref(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain version: (B, I), (B, I) -> (I,) = sum_b a*g in fp32."""
    return (a.float() * g.float()).sum(0)


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
