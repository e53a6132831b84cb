"""Weight-level alignment (WLA) baseline: FedMA-style matched averaging.

The paper's §2.4 comparison class, reduced to its one-shot core: per
layer, Hungarian-match each client's neurons to a reference client by
weight distance (squared error), permute them losslessly (Eq. 2-4),
then average. The port of the reference's ``core/matching.py`` on the
port's layouts:

- conv weights are OIHW, so a layer's output permutation indexes dim 0
  and the next conv's input permutation dim 1; a neuron row lists
  (I, kh, kw) where the reference's lists (kh, kw, I): the squared
  distances are the same sums in another order (equal up to float64
  round-off);
- the first FC reads the reference's flatten order, (H, W, C) with C
  fastest (``models/cnn.flatten_features``), so its rows permute as the
  reference's do;
- dense weights (d_in, d_out) and per-channel vectors as the reference.

The (I, I) cost matrices are built in float64 on the params' device;
only they go to the host, for scipy's ``linear_sum_assignment``. The
permutations and the average stay on the device. The average is the
plain ``fedavg`` (no kernel), as the reference's.

Defined for non-grouped CNNs (plans of "c" convs and an FC stack):
matching a grouped model is Fed2's job, done structurally.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from repro_torch.models.cnn import CNNConfig, layer_meta
from repro_torch.models.module import FlatLayout, tree_leaves, tree_map


def _copy(params):
    return {"convs": [dict(l) for l in params["convs"]],
            "fcs": [dict(l) for l in params["fcs"]]}


def _neuron_matrix(layer, kind):
    """Per-output-neuron flattened weight rows (I, fan_in[+1])."""
    w = layer["w"]
    rows = w.reshape(w.shape[0], -1) if kind == "c" else w.T
    if "b" in layer:
        rows = torch.cat([rows, layer["b"][:, None]], dim=1)
    return rows


def match_permutation(ref_rows, rows) -> np.ndarray:
    """Hungarian assignment minimizing sum_i ||ref_i - rows[perm[i]]||^2.
    Returns perm aligning ``rows`` to ``ref``."""
    ref = ref_rows.to(torch.float64)
    cur = rows.to(torch.float64)
    cost = ((ref * ref).sum(1)[:, None] + (cur * cur).sum(1)[None, :]
            - 2.0 * ref @ cur.T)
    ri, ci = linear_sum_assignment(cost.cpu().numpy())
    perm = np.empty(len(ci), dtype=np.int64)
    perm[ri] = ci
    return perm


def permute_cnn_neurons(params, cfg: CNNConfig, layer_idx: int, perm):
    """Losslessly permute the output neurons of weight-layer
    ``layer_idx`` and the next layer's matching input coordinates, Eq.
    4's (w_{l+1} Π)(Πᵀ w_l). Supports "c" convs and inner "fc" layers."""
    metas = layer_meta(cfg)
    n_convs = sum(1 for m in metas if m.kind in ("c", "dw"))
    params = _copy(params)
    m = metas[layer_idx]
    if m.kind not in ("c", "fc") or m.groups != 1:
        raise ValueError(f"layer {layer_idx} ({m}) is not a matchable "
                         "dense conv or inner FC")
    perm = torch.as_tensor(np.asarray(perm),
                           device=tree_leaves(params)[0].device)

    if m.kind == "c":
        layer = dict(params["convs"][layer_idx])
        layer["w"] = layer["w"][perm]
        if "b" in layer:
            layer["b"] = layer["b"][perm]
        if "norm" in layer:
            layer["norm"] = {k: v[perm] for k, v in layer["norm"].items()}
        params["convs"][layer_idx] = layer
        nxt = metas[layer_idx + 1]
        if nxt.kind == "c":
            nlayer = dict(params["convs"][layer_idx + 1])
            nlayer["w"] = nlayer["w"][:, perm]
            params["convs"][layer_idx + 1] = nlayer
        elif nxt.kind == "dw":
            # depthwise (c_in, 1, k, k) follows its input channels; the
            # pointwise (c_out, c_in, 1, 1) reads them on dim 1
            nlayer = dict(params["convs"][layer_idx + 1])
            nlayer["dw"] = {"w": nlayer["dw"]["w"][perm],
                            "b": nlayer["dw"]["b"][perm]}
            nlayer["w"] = {**nlayer["w"], "w": nlayer["w"]["w"][:, perm]}
            params["convs"][layer_idx + 1] = nlayer
        else:  # fc reading the flattened (H, W, C) features, C fastest
            fc = dict(params["fcs"][0])
            din, dout = fc["w"].shape
            spatial = din // m.c_out
            fc["w"] = fc["w"].reshape(spatial, m.c_out, dout)[:, perm, :] \
                .reshape(din, dout)
            params["fcs"][0] = fc
    else:
        fi = layer_idx - n_convs
        fc = dict(params["fcs"][fi])
        fc["w"] = fc["w"][:, perm]
        if "b" in fc:
            fc["b"] = fc["b"][perm]
        params["fcs"][fi] = fc
        nfc = dict(params["fcs"][fi + 1])
        nfc["w"] = nfc["w"][perm, :]
        params["fcs"][fi + 1] = nfc
    return params


def matchable_layers(cfg: CNNConfig):
    metas = layer_meta(cfg)
    return [i for i, m in enumerate(metas)
            if m.kind in ("c", "fc") and m.groups == 1
            and i < len(metas) - 1]


def matched_average(stacked, cfg: CNNConfig, weights=None):
    """One-shot FedMA-style matched averaging: align every client to
    client 0 layer by layer (shallow to deep), then FedAvg. stacked: a
    params tree of (N, ...) leaves; returns one client's tree."""
    from repro_torch.core.fusion import fedavg
    n = tree_leaves(stacked)[0].shape[0]
    clients = [tree_map(lambda a, i=i: a[i], stacked) for i in range(n)]
    metas = layer_meta(cfg)
    n_convs = sum(1 for m in metas if m.kind in ("c", "dw"))
    ref = clients[0]
    aligned = [ref]
    for c in clients[1:]:
        cur = c
        for li in matchable_layers(cfg):
            m = metas[li]
            if m.kind == "c":
                ref_layer, cur_layer = ref["convs"][li], cur["convs"][li]
            else:
                ref_layer = ref["fcs"][li - n_convs]
                cur_layer = cur["fcs"][li - n_convs]
            perm = match_permutation(_neuron_matrix(ref_layer, m.kind),
                                     _neuron_matrix(cur_layer, m.kind))
            cur = permute_cnn_neurons(cur, cfg, li, perm)
        aligned.append(cur)
    layout = FlatLayout(ref)
    buf = layout.alloc((n,), device=tree_leaves(ref)[0].device,
                       dtype=tree_leaves(ref)[0].dtype)
    for i, client in enumerate(aligned):
        layout.flatten(client, out=buf[i])
    return layout.unflatten(fedavg(buf, weights))
