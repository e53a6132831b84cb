"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) block: the
decode half of ``repro.models.ssm``.

Decode is the O(1) recurrent state update, one token at a time. The
reference's chunked SSD scan (``ssd_chunked``) and full-sequence mixer
(``mamba2_apply``), its prefill and training path, are not ported yet:
the port's serving loop prefills by repeated decode, as the reference's
``launch/serve.py`` does.

Layout: x (B, H, P) heads x headdim; B/C projections shared across
heads (ngroups = 1); A is a per-head scalar decay (log-parameterized).
Parameters keep the reference's shapes, so weights map across one to
one (``convert.lm_to_port``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_update import ssd_update
from repro_torch.models.layers import (conv1d_depthwise_init, dense_apply,
                                       dense_init, rmsnorm_apply,
                                       rmsnorm_init, silu)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    chunk: int = 256

    @property
    def d_inner(self):
        return self.expand * self.d_model

    @property
    def n_heads(self):
        return self.d_inner // self.headdim

    @property
    def conv_dim(self):
        return self.d_inner + 2 * self.d_state


def ssd_step(hstate, x, dt, a_log, b, c, d_skip):
    """Single-token recurrence. x: (B, H, P); dt: (B, H); b, c: (B, N);
    hstate: (B, H, P, N). Returns (new state, y in x's dtype)."""
    a = -torch.exp(a_log.to(torch.float32))
    da = torch.exp(dt.to(torch.float32) * a)                 # (B, H)
    upd = torch.einsum("bh,bn,bhp->bhpn", dt.to(torch.float32),
                       b.to(torch.float32), x.to(torch.float32))
    hstate = da[..., None, None] * hstate + upd
    y = torch.einsum("bn,bhpn->bhp", c.to(torch.float32), hstate)
    y = y + d_skip[None, :, None] * x.to(torch.float32)
    return hstate, y.to(x.dtype)


# ---------------------------------------------------------------------------
# Full Mamba2 mixer block
# ---------------------------------------------------------------------------


def mamba2_init(gen, cfg: SSMConfig, dtype=torch.float32):
    """Input projections SPLIT (w_z, w_xbc, w_dt) as in the reference.
    Drawn on the generator's device; ``a_log``, ``dt_bias`` and
    ``d_skip`` are fp32 whatever ``dtype`` is."""
    di, h, dev = cfg.d_inner, cfg.n_heads, gen.device
    f32 = torch.float32
    return {
        "w_z": dense_init(gen, cfg.d_model, di, dtype=dtype),
        "w_xbc": dense_init(gen, cfg.d_model, cfg.conv_dim, dtype=dtype),
        "w_dt": dense_init(gen, cfg.d_model, h, dtype=dtype),
        "conv": conv1d_depthwise_init(gen, cfg.conv_dim, cfg.conv_kernel,
                                      dtype=dtype),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=f32,
                                          device=dev)),
        "dt_bias": torch.zeros((h,), dtype=f32, device=dev),
        "d_skip": torch.ones((h,), dtype=f32, device=dev),
        "norm": rmsnorm_init(di, dtype, device=dev),
        "out_proj": dense_init(gen, di, cfg.d_model, dtype=dtype),
    }


def _project_in(p, x):
    return dense_apply(p["w_z"], x), dense_apply(p["w_xbc"], x), \
        dense_apply(p["w_dt"], x)


def mamba2_cache_init(cfg: SSMConfig, batch: int, dtype, device=None):
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, cfg.conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.n_heads, cfg.headdim, cfg.d_state),
                           dtype=torch.float32, device=device),
    }


def conv_step(p_conv, conv_state, xbc):
    """The depthwise causal conv at one new position: the window is the
    last k-1 inputs (``conv_state``, (B, k-1, C)) and ``xbc`` (B, C).
    Returns (silu(window . w + b) (B, C), the next state)."""
    window = torch.cat([conv_state, xbc[:, None]], dim=1)    # (B, k, C)
    w = p_conv["w"][:, 0, :]                                 # (k, C)
    out = silu((window * w).sum(dim=1) + p_conv["b"])
    return out, window[:, 1:]


def mamba2_decode(p, x, cache, cfg: SSMConfig, *, use_kernel: bool = True):
    """One-token step. x: (B, 1, d_model). Updates ``cache`` IN PLACE
    (the reference returns a new one) and returns (out, cache): the conv
    state is overwritten, and the SSM state is rewritten by the
    ``ssd_update`` kernel in its own buffer. ``use_kernel=False`` takes
    ``ssd_step`` (the on-card comparison's plain route)."""
    bs = x.shape[0]
    di, n, h = cfg.d_inner, cfg.d_state, cfg.n_heads
    z, xbc, dt = _project_in(p, x[:, 0])
    xbc, new_conv = conv_step(p["conv"], cache["conv"], xbc)
    cache["conv"].copy_(new_conv)
    xs = xbc[..., :di].reshape(bs, h, cfg.headdim)
    bmat = xbc[..., di:di + n]
    cmat = xbc[..., di + n:]
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    if use_kernel:
        _, y = ssd_update(cache["ssm"], xs, dt, p["a_log"], bmat, cmat,
                          p["d_skip"], out=cache["ssm"])
    else:
        state, y = ssd_step(cache["ssm"], xs, dt, p["a_log"], bmat, cmat,
                            p["d_skip"])
        cache["ssm"].copy_(state)
    y = y.reshape(bs, 1, di)
    y = rmsnorm_apply(p["norm"], y * silu(z[:, None]))
    return dense_apply(p["out_proj"], y), cache
