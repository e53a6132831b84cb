"""Primitive layers: dense, grouped (block-diagonal) dense, conv2d with
feature groups, GroupNorm and batch-statistics BatchNorm; for the LMs,
RMSNorm, LayerNorm, the depthwise causal conv1d, rotary position
embeddings, the embedding, SiLU and GELU.

Each layer is an (init, apply) pair of plain functions over a dict of
tensors, so the round engine can take gradients per client with
``torch.func`` over the cohort. Activations are NCHW; conv weights are
OIHW ``(c_out, c_in/groups, k, k)`` (``convert.py`` maps the reference's
HWIO). Dense weights keep the reference's ``(d_in, d_out)`` and grouped
dense weights its block-diagonal ``(G, d_in/G, d_out/G)``: gradients
cannot cross groups, Fed2's feature isolation (Eq. 13-14).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.module import default_init, draw_device

# ---------------------------------------------------------------------------
# Dense / GroupedDense
# ---------------------------------------------------------------------------


def dense_init(gen, d_in: int, d_out: int, *, bias: bool = False,
               dtype=torch.float32):
    p = {"w": default_init(gen, (d_in, d_out), fan_in=d_in, dtype=dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype,
                             device=draw_device(gen))
    return p


def dense_apply(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def grouped_dense_init(gen, groups: int, d_in: int, d_out: int, *,
                       bias: bool = False, dtype=torch.float32):
    """Block-diagonal dense: group g maps the g-th input slice to the
    g-th output slice."""
    if d_in % groups or d_out % groups:
        raise ValueError(f"grouped dense needs d_in and d_out divisible by "
                         f"groups, got {d_in}, {d_out}, {groups}")
    gi, go = d_in // groups, d_out // groups
    p = {"w": default_init(gen, (groups, gi, go), fan_in=gi, dtype=dtype)}
    if bias:
        p["b"] = torch.zeros((groups, go), dtype=dtype,
                             device=draw_device(gen))
    return p


def grouped_dense_apply(p, x, *, use_kernel: bool = False):
    """x: (..., G*gi) -> (..., G*go). ``use_kernel`` routes the product
    through ``kernels/grouped_matmul.py`` (the hand-written kernel on CUDA
    tensors, its plain version on the CPU). It has no backward (it raises
    under autograd on the card), so it is opt-in and for no-grad passes
    only: every training path keeps the einsum, as the reference does."""
    if use_kernel:
        from repro_torch.kernels.grouped_matmul import grouped_matmul
        return grouped_matmul(x.contiguous(), p["w"], p.get("b"))
    g, gi, go = p["w"].shape
    xg = x.reshape(x.shape[:-1] + (g, gi))
    y = torch.einsum("...gi,gio->...go", xg, p["w"])
    if "b" in p:
        y = y + p["b"]
    return y.reshape(x.shape[:-1] + (g * go,))


# ---------------------------------------------------------------------------
# LM layers: RMSNorm, LayerNorm, depthwise causal conv1d, RoPE, embedding,
# SiLU, GELU
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_apply(p, x, *, eps: float = 1e-6):
    """RMSNorm over the last axis: fp32 statistics, cast back to x's
    dtype, then multiplied by the scale (the reference's order)."""
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"]


def layernorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm_apply(p, x, *, eps: float = 1e-5):
    """LayerNorm over the last axis in the reference's rounding order:
    the mean and the population variance in fp32, the normalized value
    cast to x's dtype, THEN the scale and the bias applied in that
    dtype (``F.layer_norm`` rounds once, after the affine step: in bf16
    another function)."""
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * p["scale"] + p["bias"]


def conv1d_depthwise_init(gen, channels: int, k: int, dtype=torch.float32):
    """Depthwise causal conv1d (Mamba-style): weight ``(k, 1, C)`` as in
    the reference (its "LIO" layout), bias ``(C,)``."""
    return {"w": default_init(gen, (k, 1, channels), fan_in=k, dtype=dtype),
            "b": torch.zeros((channels,), dtype=dtype,
                             device=draw_device(gen))}


def conv1d_depthwise_apply(p, x):
    """The depthwise causal conv over a whole sequence: x (B, L, C) ->
    (B, L, C), ``y[t] = sum_k x[t - (k-1) + i] w[i] + b`` with zeros
    before the first position (the reference's cross-correlation; the
    decode's ``ssm.conv_step`` is one position of it)."""
    k, l = p["w"].shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    y = xp[:, :l] * p["w"][0, 0]
    for i in range(1, k):
        y = y + xp[:, i:i + l] * p["w"][i, 0]
    return y + p["b"]


def rope_freqs(head_dim: int, theta: float = 10000.0,
               rotary_dim: int | None = None, *, device=None):
    """The rotary inverse frequencies ``theta^(-2i/rd)``, (rd/2,) fp32,
    computed in numpy's float32 as the reference computes them."""
    rd = rotary_dim if rotary_dim is not None else head_dim
    if rd % 2:
        raise ValueError(f"rotary_dim must be even, got {rd}")
    inv = 1.0 / (theta ** (np.arange(0, rd, 2, dtype=np.float32) / rd))
    return torch.as_tensor(inv, device=device)


def apply_rope(x, positions, inv_freq, *, rotary_dim: int | None = None):
    """x (B, S, H, D); positions (B, S) int. Rotates the first
    ``rotary_dim`` features by fp32 angles ``position * inv_freq``, the
    two halves concatenated (not interleaved), and passes the rest
    through; the result in x's dtype."""
    d = x.shape[-1]
    rd = rotary_dim if rotary_dim is not None else d
    ang = positions[..., None].to(torch.float32) * inv_freq   # (B,S,rd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr, xp = x[..., :rd], x[..., rd:]
    x1, x2 = xr[..., :rd // 2], xr[..., rd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                    dim=-1).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rd < d else out


def embed_init(gen, vocab: int, d: int, dtype=torch.float32):
    return {"table": default_init(gen, (vocab, d), fan_in=d, dtype=dtype)}


def embed_apply(p, ids):
    return p["table"][ids]


def silu(x):
    return x * torch.sigmoid(x)


def gelu(x):
    """GELU, tanh form (``jax.nn.gelu``'s default)."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# Norms (over NCHW activations, statistics in fp32)
# ---------------------------------------------------------------------------


def groupnorm_init(d: int, dtype=torch.float32):
    return {"scale": torch.ones((d,), dtype=dtype),
            "bias": torch.zeros((d,), dtype=dtype)}


def groupnorm_apply(p, x, *, groups: int, eps: float = 1e-5):
    """GroupNorm (Wu & He 2018), per Fed2 §5.1: statistics per (sample,
    group) over the group's channels and all spatial positions."""
    b, c = x.shape[:2]
    if c % groups:
        raise ValueError(f"GroupNorm: {c} channels in {groups} groups")
    xg = x.to(torch.float32).reshape((b, groups, c // groups)
                                     + tuple(x.shape[2:]))
    red = tuple(range(2, xg.dim()))
    mu = xg.mean(dim=red, keepdim=True)
    var = xg.var(dim=red, unbiased=False, keepdim=True)
    y = ((xg - mu) * torch.rsqrt(var + eps)).reshape(x.shape).to(x.dtype)
    shape = (1, c) + (1,) * (x.dim() - 2)
    return y * p["scale"].reshape(shape) + p["bias"].reshape(shape)


def batchnorm_init(d: int, dtype=torch.float32):
    # training-mode batch statistics (per batch, as in FL local training)
    return {"scale": torch.ones((d,), dtype=dtype),
            "bias": torch.zeros((d,), dtype=dtype)}


def batchnorm_apply(p, x, *, eps: float = 1e-5):
    """Batch-statistics normalization over every axis but channels."""
    c = x.shape[1]
    x32 = x.to(torch.float32)
    red = (0,) + tuple(range(2, x.dim()))
    mu = x32.mean(dim=red, keepdim=True)
    var = x32.var(dim=red, unbiased=False, keepdim=True)
    y = ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    shape = (1, c) + (1,) * (x.dim() - 2)
    return y * p["scale"].reshape(shape) + p["bias"].reshape(shape)


# ---------------------------------------------------------------------------
# Convolutions (NCHW / OIHW)
# ---------------------------------------------------------------------------


def conv2d_init(gen, c_in: int, c_out: int, k: int, *, groups: int = 1,
                bias: bool = True, dtype=torch.float32):
    if c_in % groups or c_out % groups:
        raise ValueError(f"conv2d: {c_in}->{c_out} channels in {groups} "
                         "groups")
    fan_in = (c_in // groups) * k * k
    p = {"w": default_init(gen, (c_out, c_in // groups, k, k),
                           fan_in=fan_in, dtype=dtype)}
    if bias:
        p["b"] = torch.zeros((c_out,), dtype=dtype)
    return p


def same_padding(size: int, k: int, stride: int) -> tuple:
    """XLA's "SAME" padding of one spatial dim: the output has
    ceil(size / stride) positions, and the total pad splits with the
    odd element AFTER the input. For size 32, k 3, stride 2 that is
    (0, 1), not (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d_apply(p, x, *, stride: int = 1, groups: int = 1):
    """Convolution with the reference's "SAME" padding (XLA's rule,
    ``same_padding``). A symmetric pad goes to ``F.conv2d`` itself (every
    stride-1 conv with an odd kernel); an asymmetric one is applied
    explicitly first."""
    kh, kw = p["w"].shape[-2:]
    ph = same_padding(x.shape[-2], kh, stride)
    pw = same_padding(x.shape[-1], kw, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, p["w"], p.get("b"), stride=stride,
                        padding=(ph[0], pw[0]), groups=groups)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, p["w"], p.get("b"), stride=stride, groups=groups)
