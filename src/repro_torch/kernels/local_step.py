"""Fused momentum-SGD step over the cohort's flat parameter buffer.

Replaces the TPU kernel ``local_step_kernel`` of
``src/repro/kernels/local_step.py`` together with its wrapper
(``repro/kernels/ops.py:local_step``) and oracle
(``repro/kernels/ref.py:local_step_ref``). The kernel is Triton:

    v' = mu * v + g
    p' = p - lr * v'

in fp32 whatever the storage dtype (fp32 or bf16), over R rows of M
values each (the engine passes its whole (cohort, M) buffer: one launch
per local step).

Bound on the H100: bytes. Each element reads p, v and g once and
writes p and v once, five accesses for four flops; at 10 clients and
the full VGG9 (M = 0.52 M fp32) one step moves 104 MB, about 31 us at
3.35 TB/s. The TPU kernel streams padded (1, M) tiles through VMEM;
here one program owns a 1024-wide block of one row, with masked loads
(so no padding copy) that compile to 16-byte vector accesses, and the
row strides come in as arguments so the engine's strided views are
taken as they are. **p and v are updated in place**: the kernel writes
p' over p and v' over v, and the wrapper returns the same tensors.

``local_step`` is the wrapper: on CPU tensors it computes
``local_step_ref`` and copies the result into p and v; on CUDA tensors
it launches the kernel or raises. ``local_step.launches`` counts kernel
launches.
"""
from __future__ import annotations

import torch

_BLOCK = 1024
_KERNEL = None
tl = None          # triton.language, bound when the kernel is first built


def local_step_ref(p: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                   lr: float, mu: float) -> tuple:
    """The plain version: returns new (p', v') in the storage dtypes."""
    v2 = mu * v.to(torch.float32) + g.to(torch.float32)
    p2 = p.to(torch.float32) - lr * v2
    return p2.to(p.dtype), v2.to(v.dtype)


def _local_step_kernel(p_ptr, v_ptr, g_ptr, m, p_ld, v_ld, g_ld, lr, mu,
                       BLOCK: tl.constexpr):
    row = tl.program_id(1).to(tl.int64)
    cols = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = cols < m
    p_row = p_ptr + row * p_ld + cols
    v_row = v_ptr + row * v_ld + cols
    g_row = g_ptr + row * g_ld + cols
    v = (mu * tl.load(v_row, mask=mask).to(tl.float32)
         + tl.load(g_row, mask=mask).to(tl.float32))
    p = tl.load(p_row, mask=mask).to(tl.float32) - lr * v
    tl.store(v_row, v.to(v_ptr.dtype.element_ty), mask=mask)
    tl.store(p_row, p.to(p_ptr.dtype.element_ty), mask=mask)


def _kernel():
    """The jitted kernel; imports triton on first use (never at module
    import, so the module loads where triton is absent)."""
    global _KERNEL, tl
    if _KERNEL is None:
        import triton
        import triton.language
        tl = triton.language
        _KERNEL = triton.jit(_local_step_kernel)
    return _KERNEL


def _as_rows(t: torch.Tensor) -> torch.Tensor:
    return t.unsqueeze(0) if t.dim() == 1 else t


def _check(p, v, g):
    if p.dim() not in (1, 2) or p.shape != v.shape or p.shape != g.shape:
        raise ValueError(
            f"local_step takes equal 1-D or 2-D shapes, got "
            f"{tuple(p.shape)}, {tuple(v.shape)}, {tuple(g.shape)}")
    for name, t in (("p", p), ("v", v), ("g", g)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"local_step: {name} must be float32 or "
                            f"bfloat16, got {t.dtype}")
        if t.device != p.device:
            raise ValueError("local_step: p, v and g must share a device")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"local_step: {name} needs unit stride along "
                             "its last axis")


def local_step(p: torch.Tensor, v: torch.Tensor, g: torch.Tensor, *,
               lr: float, mu: float) -> tuple:
    """One momentum-SGD step on (M,) or (R, M) tensors, IN PLACE on p
    and v; returns (p, v). Rows may be strided views."""
    _check(p, v, g)
    if p.device.type == "cpu":
        p2, v2 = local_step_ref(p, v, g, lr, mu)
        p.copy_(p2)
        v.copy_(v2)
        return p, v
    if p.device.type != "cuda":
        raise ValueError(f"local_step: unsupported device {p.device}")
    kernel = _kernel()
    pr, vr, gr = _as_rows(p), _as_rows(v), _as_rows(g)
    rows, m = pr.shape
    grid = (-(-m // _BLOCK), rows)
    with torch.cuda.device(p.device):
        kernel[grid](pr, vr, gr, m, pr.stride(0), vr.stride(0),
                     gr.stride(0), float(lr), float(mu), BLOCK=_BLOCK,
                     num_warps=4)
    local_step.launches += 1
    return p, v


local_step.launches = 0
