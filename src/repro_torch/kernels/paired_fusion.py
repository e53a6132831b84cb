"""Fused N-way weighted client averaging: the fusion fast path.

Replaces the TPU kernel ``paired_fusion_kernel`` of
``src/repro/kernels/paired_fusion.py`` together with its wrapper
(``repro/kernels/ops.py:paired_fusion``) and oracle
(``repro/kernels/ref.py:paired_fusion_ref``). The kernel itself is CUDA
C++ for Hopper in ``csrc/paired_fusion.cu``, built by ``kernels/build.py``
and bound with ctypes.

Bound on the H100: bytes. Fusing N stacked rows of M parameters reads
N*M values and writes M, for 2*N*M flops: at N=10 and the full VGG9's
M = 0.52 M fp32 parameters that is 21 MB, about 6 us at 3.35 TB/s,
against well under 1 us of arithmetic. The kernel therefore reads each
value exactly once with 16-byte loads, keeps the fp32 accumulators in
registers (each thread owns a few columns and loops over N), and takes
the rows through a row stride, so group blocks and leaves of the
engine's flat cohort buffer fuse in place without a gather or a pad.

``paired_fusion`` is the wrapper: on a CPU tensor it computes
``paired_fusion_ref``; on a CUDA tensor it launches the kernel or
raises. ``paired_fusion.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROWS = 12288          # csrc/paired_fusion.cu: N weights in 48 KB


def paired_fusion_ref(stacked: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """The plain version: (N, M) x normalized (N,) -> (M,), fp32
    accumulation, result in the input dtype."""
    w = weights.to(torch.float32)[:, None]
    return (stacked.to(torch.float32) * w).sum(0).to(stacked.dtype)


def _library() -> ctypes.CDLL:
    lib = build.load("paired_fusion")
    fn = lib.paired_fusion_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(stacked, weights, out):
    if stacked.dim() != 2:
        raise ValueError(
            f"paired_fusion takes a 2-D (N, M) stack, got shape "
            f"{tuple(stacked.shape)}")
    n, m = stacked.shape
    if stacked.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"paired_fusion takes float32 or bfloat16 rows, got "
            f"{stacked.dtype}")
    if m > 1 and stacked.stride(1) != 1:
        raise ValueError("paired_fusion needs unit column stride")
    if n < 1 or n > _MAX_ROWS:
        raise ValueError(f"paired_fusion takes 1..{_MAX_ROWS} rows, "
                         f"got {n}")
    if (weights.dim() != 1 or weights.shape[0] != n
            or weights.dtype != torch.float32):
        raise ValueError(
            f"paired_fusion needs ({n},) float32 weights, got "
            f"{tuple(weights.shape)} {weights.dtype}")
    if weights.device != stacked.device:
        raise ValueError("weights and rows must share a device")
    if out is not None and (out.shape != (m,) or out.dtype != stacked.dtype
                            or out.device != stacked.device
                            or (m > 1 and out.stride(0) != 1)):
        raise ValueError(
            f"out must be a contiguous ({m},) {stacked.dtype} tensor on "
            f"{stacked.device}")


def paired_fusion(stacked: torch.Tensor, weights: torch.Tensor,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted mean of the rows of ``stacked`` (N, M) under ``weights``
    (N,) float32 that sum to one. Writes into ``out`` (M,) when given
    (it may be a slice of a larger vector), else allocates. CPU tensors
    take ``paired_fusion_ref``; CUDA tensors launch the kernel."""
    _check(stacked, weights, out)
    n, m = stacked.shape
    if stacked.device.type == "cpu":
        res = paired_fusion_ref(stacked, weights)
        return res if out is None else out.copy_(res)
    if stacked.device.type != "cuda":
        raise ValueError(f"paired_fusion: unsupported device "
                         f"{stacked.device}")
    weights = weights.contiguous()
    if out is None:
        out = torch.empty(m, dtype=stacked.dtype, device=stacked.device)
    lib = _library()
    with torch.cuda.device(stacked.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.paired_fusion_launch(
            stacked.data_ptr(), stacked.stride(0), weights.data_ptr(),
            out.data_ptr(), n, m, _DTYPE_CODES[stacked.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paired_fusion kernel launch failed: CUDA "
                           f"error {err}")
    paired_fusion.launches += 1
    return out


paired_fusion.launches = 0
