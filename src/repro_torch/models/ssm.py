"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) block: the port
of ``repro.models.ssm``.

Train/prefill uses the chunked SSD algorithm (``ssd_chunked``): a Python
loop over chunks, each an intra-chunk attention-like product plus the
read-out of the carried state, and the inter-chunk state recurrence, so
one (B, Q, Q, H) decay tile is alive at a time. Each chunk's body is
rematerialized on the plain-autograd route (``models.module.
rematerialized``), as the reference checkpoints its scan body. Decode
is the O(1) recurrent state update, one token at a time; the port's
serving loop prefills by repeated decode, as the reference's
``launch/serve.py`` does.

Layout: x (B, L, H, P) heads x headdim; B/C projections shared across
heads (ngroups = 1); A is a per-head scalar decay (log-parameterized).
Parameters keep the reference's shapes, so weights map across one to
one (``convert.lm_to_port``).

On a mesh of model ranks (``mesh=``) a rank holds a block of w_z's and
w_xbc's columns, of the conv's channels and of out_proj's rows, and the
SSM heads its block of z covers; its conv channels (a block of x|B|C,
which does not line up with the heads) are all-gathered after the conv,
so the rank reads its heads of x and the whole of B and C. The gated
RMSNorm spans all of ``d_inner``: its sum of squares is summed over
"model" before out_proj's row-parallel product.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_update import ssd_update
from repro_torch.models.layers import (conv1d_depthwise_apply,
                                       conv1d_depthwise_init, dense_apply,
                                       dense_init, rmsnorm_apply,
                                       rmsnorm_init, silu)
from repro_torch.models.module import draw_device, rematerialized
from repro_torch.models.parallel import (gather_last, is_split,
                                         model_coord, rmsnorm_split,
                                         row_dense, split)


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


def _ssd_chunk(hstate, xc, dtc, bc, cc, a, d_skip, tri):
    """One chunk of ``ssd_chunked``: (carried state (B, H, P, N), the
    chunk's x (B, q, H, P), dt (B, q, H), b and c (B, q, N)) -> (the
    state after the chunk, y (B, q, H, P) in fp32). The reference's
    scan body; its four- and three-operand einsums are written as
    two-operand contractions in the reference's operand order, so no
    (B, q, q, H, P) product is ever formed."""
    f32 = torch.float32
    dtc, bc, cc, xc = (dtc.to(f32), bc.to(f32), cc.to(f32), xc.to(f32))
    da = dtc * a                              # (B, q, H) log-decay, < 0
    cum = torch.cumsum(da, dim=1)             # inclusive cumsum
    total = cum[:, -1]                        # (B, H)
    # pairwise decay exp(cum_i - cum_j) for i >= j, masked in log space:
    # exp of the upper triangle would overflow, and inf * 0 is NaN in
    # the backward pass
    logdec = cum[:, :, None, :] - cum[:, None, :, :]          # (B, i, j, H)
    ldec = torch.exp(torch.where(tri[None, :, :, None], logdec,
                                 float("-inf")))
    cb = torch.einsum("bin,bjn->bij", cc, bc)
    # intra = einsum("bij,bijh,bjh,bjhp->bihp", cb, ldec, dt, x)
    m = cb[..., None] * ldec * dtc[:, None]                   # (B, i, j, H)
    intra = torch.einsum("bijh,bjhp->bihp", m, xc)
    # the carried state, decayed to position i and read out:
    # einsum("bih,bin,bhpn->bihp", exp(cum), c, h)
    ec = torch.exp(cum)[..., None] * cc[:, :, None, :]        # (B, i, H, N)
    y_prev = torch.einsum("bihn,bhpn->bihp", ec, hstate)
    # the chunk's own state: sum_j exp(total - cum_j) dt_j B_j x_j^T
    # einsum("bjh,bjn,bjhp->bhpn", decay_out * dt, b, x)
    decay_out = torch.exp(total[:, None] - cum)               # (B, q, H)
    wb = (decay_out * dtc)[..., None] * bc[:, :, None, :]     # (B, j, H, N)
    s_new = torch.einsum("bjhn,bjhp->bhpn", wb, xc)
    hstate = torch.exp(total)[:, :, None, None] * hstate + s_new
    y = intra + y_prev + d_skip[None, None, :, None] * xc
    return hstate, y


def ssd_chunked(x, dt, a_log, b, c, d_skip, *, chunk: int):
    """Chunked SSD scan. x: (B, L, H, P); dt: (B, L, H) (post-softplus,
    > 0); a_log: (H,) (A = -exp); b, c: (B, L, N); d_skip: (H,).
    Returns (y (B, L, H, P) in x's dtype, the final state (B, H, P, N)
    fp32). L is right-padded to a multiple of q = min(chunk, L); the
    padding (dt = 0 there) leaves the state as it was."""
    bs, l, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, l)
    nc = -(-l // q)
    pad = nc * q - l

    def chunks(t):
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape((bs, nc, q) + tuple(t.shape[2:])).unbind(1)

    a = -torch.exp(a_log.to(torch.float32))                   # (H,) < 0
    tri = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    hstate = x.new_zeros((bs, h, p, n), dtype=torch.float32)
    ys = []
    for xc, dtc, bc, cc in zip(chunks(x), chunks(dt), chunks(b), chunks(c)):
        hstate, y = rematerialized(_ssd_chunk, hstate, xc, dtc, bc, cc, a,
                                   d_skip, tri)
        ys.append(y.to(x.dtype))
    return torch.cat(ys, dim=1)[:, :l], hstate


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
    Drawn on ``draw_device(gen)``; ``a_log``, ``dt_bias`` and
    ``d_skip`` are fp32 whatever ``dtype`` is."""
    di, h, dev = cfg.d_inner, cfg.n_heads, draw_device(gen)
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


def _heads(cfg: SSMConfig, mesh) -> tuple:
    """The rank's SSM heads [lo, lo + n) and its x|B|C channels' split
    (which must be even)."""
    split(cfg.conv_dim, mesh, "conv channels")
    n = split(cfg.n_heads, mesh, "SSM heads")
    return model_coord(mesh) * n, n


def _mamba2_ranks(p, z, xbc, dt, cfg: SSMConfig, mesh, ssd):
    """The rank's mixer after its projections and conv: ``xbc`` its conv
    channels (all-gathered here), ``ssd(xs, dt, a_log, b, c, d_skip)``
    -> y (B, ..., heads, P) the SSD of its heads; the gated RMSNorm and
    out_proj's rows."""
    lo, n = _heads(cfg, mesh)
    di, ns, hp = cfg.d_inner, cfg.d_state, cfg.headdim
    xbc = gather_last(xbc, mesh)
    xs = xbc[..., lo * hp:(lo + n) * hp]
    xs = xs.reshape(xs.shape[:-1] + (n, hp))
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])[..., lo:lo + n]
    y = ssd(xs, dt.contiguous(), p["a_log"][lo:lo + n],
            xbc[..., di:di + ns], xbc[..., di + ns:], p["d_skip"][lo:lo + n])
    y = y.reshape(z.shape)
    y = rmsnorm_split(p["norm"]["scale"][lo * hp:(lo + n) * hp],
                      y * silu(z), mesh, di)
    return row_dense(p["out_proj"], y, mesh)


def mamba2_apply(p, x, cfg: SSMConfig, *, with_state: bool = False,
                 mesh=None):
    """Full-sequence mixer. x: (B, L, d_model) -> (B, L, d_model).
    ``with_state`` also returns the SSM state after the last position
    (B, H, P, N) fp32, the state that L decode steps reach. ``mesh``:
    the rank's program on its shares."""
    bs, l, _ = x.shape
    if is_split(mesh):
        if with_state:
            raise NotImplementedError("the sharded mixer returns no state")
        z, xbc, dt = _project_in(p, x)
        return _mamba2_ranks(
            p, z, silu(conv1d_depthwise_apply(p["conv"], xbc)), dt, cfg,
            mesh, lambda *a: ssd_chunked(*a, chunk=cfg.chunk)[0])
    di, n, h = cfg.d_inner, cfg.d_state, cfg.n_heads
    z, xbc, dt = _project_in(p, x)
    xbc = silu(conv1d_depthwise_apply(p["conv"], xbc))
    xs = xbc[..., :di].reshape(bs, l, h, cfg.headdim)
    bmat = xbc[..., di:di + n]
    cmat = xbc[..., di + n:]
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    y, state = ssd_chunked(xs, dt, p["a_log"], bmat, cmat, p["d_skip"],
                           chunk=cfg.chunk)
    y = y.reshape(bs, l, di)
    y = rmsnorm_apply(p["norm"], y * silu(z))
    out = dense_apply(p["out_proj"], y)
    return (out, state) if with_state else out


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


def mamba2_decode(p, x, cache, cfg: SSMConfig, *, use_kernel: bool = True,
                  mesh=None):
    """One-token step. x: (B, 1, d_model). Updates ``cache`` IN PLACE
    (the reference returns a new one) and returns (out, cache): the conv
    state is overwritten, and the SSM state is rewritten by the
    ``ssd_update`` kernel in its own buffer. ``use_kernel=False`` takes
    ``ssd_step`` (the on-card comparison's plain route). ``mesh``: the
    rank's program on its shares; the kernel then updates its heads'
    (B, H/|model|, P, N) state."""
    bs = x.shape[0]
    di, n, h = cfg.d_inner, cfg.d_state, cfg.n_heads
    z, xbc, dt = _project_in(p, x[:, 0])
    xbc, new_conv = conv_step(p["conv"], cache["conv"], xbc)
    cache["conv"].copy_(new_conv)
    if is_split(mesh):
        def step(xs, dt, a_log, b, c, d_skip):
            if use_kernel:
                return ssd_update(cache["ssm"], xs, dt, a_log, b, c, d_skip,
                                  out=cache["ssm"])[1]
            state, y = ssd_step(cache["ssm"], xs, dt, a_log, b, c, d_skip)
            cache["ssm"].copy_(state)
            return y
        y = _mamba2_ranks(p, z[:, None], xbc, dt, cfg, mesh, step)
        return y, cache
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
