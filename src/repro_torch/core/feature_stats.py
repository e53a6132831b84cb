"""Feature interpretation (paper §3.1).

Class preference vector of a neuron (Eq. 9):
    P = [p_1 .. p_C],  p_c = sum_b A(x_{c,b}) * dZ_c / dA(x_{c,b})
where A is the neuron's (spatially pooled) activation on class-c inputs
and Z_c the class-c logit. The layer-wise feature divergence is the
total variance of the per-neuron vectors (Eq. 17):
    TV_l = (1/I) sum_i || P_{l,i} - E(P_l) ||_2

The CNN forward exposes "taps" (each weight layer's post-ReLU
activation) through additive zero offsets, so dZ_c/dA is an ordinary
``torch.autograd.grad`` with respect to the offsets: one backward pass
per class, as in the reference (``src/repro/core/feature_stats.py``).
Taps are NCHW for convs and (B, I) for dense layers.

``use_kernel=True`` gathers every class's pooled gradient into one
(C, B, I_l) buffer per tapped layer, masks the activations once per
layer into a (C, B, I_l) tensor, and reduces all of them in one call of
``kernels/feature_stats.feature_stats_many``: one kernel launch per
evaluation, written straight into the (I_l, C) preference tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.feature_stats import feature_stats_many
from repro_torch.models import cnn as cnn_lib
from repro_torch.models.layers import dense_apply, grouped_dense_apply


def apply_cnn_with_taps(params, cfg: cnn_lib.CNNConfig, x,
                        tap_offsets=None):
    """Forward returning (logits, taps): taps[i] = the post-ReLU
    activation of tapped layer i (every conv layer and hidden FC).
    ``tap_offsets`` (same shapes) are added after the ReLU: pass zeros
    and differentiate with respect to them to get dZ/dA. Like the
    reference's taps forward, this applies no PAN encoding."""
    metas = cnn_lib.layer_meta(cfg)
    convs, fcs = cnn_lib.conv_metas(metas), cnn_lib.fc_metas(metas)
    taps = []

    def tap(h):
        if tap_offsets is not None:
            h = h + tap_offsets[len(taps)]
        taps.append(h)
        return h

    x = x.permute(0, 3, 1, 2)
    ci = 0
    for step in cfg.plan:
        if step[0] == "p":
            x = torch.nn.functional.max_pool2d(x, 2)
            continue
        layer = params["convs"][ci]
        x = cnn_lib.conv_block(layer, convs[ci], x)
        x = tap(torch.relu(cnn_lib._apply_norm(cfg, layer, x)))
        ci += 1
    x = cnn_lib.flatten_features(cfg, x)
    for m, fc in zip(fcs, params["fcs"]):
        x = (grouped_dense_apply if m.grouped_fc else dense_apply)(fc, x)
        if m.kind != "logits":
            x = tap(torch.relu(x))
    return x[:, :cfg.n_classes], taps


def _pool_tap(t):
    """Spatially pool a tap to (B, neurons)."""
    return t.mean(dim=(2, 3)) if t.dim() == 4 else t


def class_preference_vectors(params, cfg, images, labels, *,
                             use_kernel: bool = False):
    """P (Eq. 9) for every tapped layer: a list, layer i -> (I_i, C)
    float32 tensors. images: (B, H, W, 3) NHWC; labels: (B,)."""
    n_cls = cfg.n_classes
    with torch.no_grad():
        _, probe_taps = apply_cnn_with_taps(params, cfg, images)
    acts = [_pool_tap(t) for t in probe_taps]              # (B, I_l)
    pvecs = [torch.zeros((a.shape[1], n_cls), dtype=torch.float32,
                         device=a.device) for a in acts]
    if use_kernel:                   # every class's pooled gradients
        gbufs = [a.new_empty((n_cls, *a.shape)) for a in acts]
    for c in range(n_cls):
        zeros = [torch.zeros_like(t, requires_grad=True)
                 for t in probe_taps]
        with torch.enable_grad():
            logits, _ = apply_cnn_with_taps(params, cfg, images, zeros)
            sel = (labels == c).to(logits.dtype)
            grads = torch.autograd.grad((logits[:, c] * sel).sum(), zeros)
        sel = (labels == c).to(torch.float32)[:, None]
        for li, (a, g) in enumerate(zip(acts, grads)):
            # mean-pooled gradient times H*W: the gradient summed over
            # the spatial positions (NCHW: dims 2 and 3)
            gp = _pool_tap(g) * (1.0 if g.dim() == 2
                                 else g.shape[2] * g.shape[3])
            if use_kernel:
                gbufs[li][c] = gp
            else:
                pvecs[li][:, c] = (a * sel * gp).sum(0).to(torch.float32)
    if use_kernel:
        onehot = (labels[None, :] == torch.arange(
            n_cls, device=labels.device)[:, None]).to(torch.float32)
        masked = [a[None] * onehot[:, :, None] for a in acts]  # (C, B, I_l)
        feature_stats_many(masked, gbufs, outs=pvecs)
    return pvecs


def total_variance(pvec):
    """Eq. 17: TV of one layer's preference vectors (I, C)."""
    mu = pvec.mean(0, keepdim=True)
    return torch.linalg.vector_norm(pvec - mu, dim=1).mean()


def layer_total_variances(params, cfg, images, labels):
    return [float(total_variance(p))
            for p in class_preference_vectors(params, cfg, images, labels)]


def primary_class(pvec):
    """Argmax class per neuron: the 'feature encoding' color of
    Fig. 1/3."""
    return torch.argmax(pvec, dim=1)


def feature_alignment_score(pvecs_per_node):
    """Fraction of (node-pair, neuron) coordinates whose primary class
    agrees: Fig. 1's alignment claim as a number. Input: one (I, C)
    tensor per node, all of the SAME layer."""
    tops = torch.stack([primary_class(p) for p in pvecs_per_node])
    n = tops.shape[0]
    agree, pairs = 0.0, 0
    for i in range(n):
        for j in range(i + 1, n):
            agree += float((tops[i] == tops[j]).to(torch.float32).mean())
            pairs += 1
    return agree / max(pairs, 1)
