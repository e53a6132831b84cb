"""Fused Mamba-2 SSD single-token decode: state update and readout.

Replaces the TPU kernel ``ssd_update_kernel`` of
``src/repro/kernels/ssd_update.py`` together with its wrapper
(``repro/kernels/ops.py:ssd_update``) and oracle
(``repro/kernels/ref.py:ssd_update_ref``)::

    h' = exp(dt * -exp(a_log)) * h + dt * (x outer b)
    y  = h' @ c + d_skip * x

for the state h (B, H, P, N) fp32, x (B, H, P), dt (B, H) fp32, b and c
(B, N) in x's dtype, a_log and d_skip (H,) fp32; h' comes back fp32 and
y in x's dtype. The kernel is CUDA C++ for Hopper in
``csrc/ssd_update.cu``, built by ``kernels/build.py`` and bound with
ctypes.

Bound on the H100: bytes. The state is read once and written once (at
batch 4 and the full Mamba-2 1.3B, 16.8 MB per layer, 5.0 us at 3.35
TB/s); the TPU kernel pads H to its head block, the CUDA kernel takes
any H, P and N and pads nothing.

``ssd_update`` is the wrapper: on CPU tensors it computes
``ssd_update_ref``; on CUDA tensors it launches the kernel or raises.
``ssd_update.launches`` counts kernel launches (one per call).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_N = 6144              # csrc/ssd_update.cu: b and c in 48 KB
_INT_MAX = 2 ** 31 - 1


def ssd_update_ref(h, x, dt, a_log, b, c, d_skip):
    """The plain version (mirrors ``models.ssm.ssd_step``); returns
    (h' in h's dtype, y in x's dtype)."""
    a = -torch.exp(a_log.to(torch.float32))
    decay = torch.exp(dt.to(torch.float32) * a)              # (B, H)
    upd = torch.einsum("bh,bn,bhp->bhpn", dt.to(torch.float32),
                       b.to(torch.float32), x.to(torch.float32))
    hnew = decay[..., None, None] * h.to(torch.float32) + upd
    y = torch.einsum("bn,bhpn->bhp", c.to(torch.float32), hnew)
    y = y + d_skip[None, :, None] * x.to(torch.float32)
    return hnew.to(h.dtype), y.to(x.dtype)


def _library() -> ctypes.CDLL:
    lib = build.load("ssd_update")
    fn = lib.ssd_update_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
        ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(h, x, dt, a_log, b, c, d_skip, out):
    if h.dim() != 4:
        raise ValueError(f"ssd_update takes a (B, H, P, N) state, got "
                         f"{tuple(h.shape)}")
    bs, hh, p, n = h.shape
    shapes = {"x": (x, (bs, hh, p)), "dt": (dt, (bs, hh)),
              "a_log": (a_log, (hh,)), "b": (b, (bs, n)), "c": (c, (bs, n)),
              "d_skip": (d_skip, (hh,))}
    if out is not None:
        shapes["out"] = (out, (bs, hh, p, n))
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"ssd_update: {name} must be {want} for the "
                             f"state {tuple(h.shape)}, got {tuple(t.shape)}")
        if t.device != h.device:
            raise ValueError("ssd_update: every input must lie on the "
                             "state's device")
    if h.numel() == 0:
        raise ValueError("ssd_update takes a non-empty state")
    for name, t in (("h", h), ("dt", dt), ("a_log", a_log),
                    ("d_skip", d_skip), ("out", out)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"ssd_update: {name} must be float32, got "
                            f"{t.dtype}")
    if x.dtype not in _DTYPE_CODES or b.dtype != x.dtype or \
            c.dtype != x.dtype:
        raise TypeError(f"ssd_update: x, b and c must be float32 or "
                        f"bfloat16 of one dtype, got {x.dtype}, {b.dtype}, "
                        f"{c.dtype}")
    if not all(t.is_contiguous() for t in (h, dt, a_log, d_skip)) or \
            (out is not None and not out.is_contiguous()):
        raise ValueError("ssd_update needs contiguous h, dt, a_log, d_skip "
                         "and out")
    # x, b and c may be views into a wider row (the decode's xbc): only
    # their batch stride is free
    if (hh > 1 and x.stride(1) != p) or (p > 1 and x.stride(2) != 1) or \
            (n > 1 and (b.stride(1) != 1 or c.stride(1) != 1)):
        raise ValueError("ssd_update: x needs contiguous (H, P) rows and "
                         "b, c contiguous N; only the batch stride is free")


def ssd_update(h, x, dt, a_log, b, c, d_skip, *, out=None):
    """One SSD decode step: returns (h', y). With ``out`` (fp32, the
    state's shape, and possibly ``h`` itself) h' is written into it and
    ``out`` is returned: ``models.ssm.mamba2_decode`` passes the cache's
    own state buffer, which is then updated in place. CPU tensors take
    ``ssd_update_ref``; CUDA tensors launch the kernel."""
    _check(h, x, dt, a_log, b, c, d_skip, out)
    if h.device.type == "cpu":
        hnew, y = ssd_update_ref(h, x, dt, a_log, b, c, d_skip)
        if out is None:
            return hnew, y
        out.copy_(hnew)
        return out, y
    if h.device.type != "cuda":
        raise ValueError(f"ssd_update: unsupported device {h.device}")
    lib = _library()
    bs, hh, p, n = h.shape
    if n > _MAX_N or bs * hh > _INT_MAX or p * n > _INT_MAX:
        raise ValueError(f"ssd_update: state {tuple(h.shape)} exceeds the "
                         f"kernel's limits (N <= {_MAX_N})")
    hout = torch.empty_like(h) if out is None else out
    y = torch.empty((bs, hh, p), dtype=x.dtype, device=h.device)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_update_launch(
            h.data_ptr(), hout.data_ptr(), x.data_ptr(), dt.data_ptr(),
            a_log.data_ptr(), b.data_ptr(), c.data_ptr(), d_skip.data_ptr(),
            y.data_ptr(), bs, hh, p, n, x.stride(0), b.stride(0),
            c.stride(0), _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssd_update kernel launch failed: CUDA error "
                           f"{err}")
    ssd_update.launches += 1
    return hout, y


ssd_update.launches = 0
