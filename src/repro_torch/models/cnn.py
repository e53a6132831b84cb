"""Paper-faithful CNN classifiers: VGG9 (FedMA variant), VGG16,
MobileNetV1.

Fed2 structure adaptation (§5.1): with ``fed2_groups = G > 0`` the last
``decouple`` weight layers become group convolutions / block-diagonal
FCs, with the logit layer decoupled so class-cluster g connects only to
structure group g (gradient redirection, Eq. 16). All channel widths are
rounded up to multiples of G. Normalization: none | bn (batch stats) |
gn (GroupNorm, per Fed2 §5.1).

Static layer topology lives in ``layer_meta(cfg)``; params are plain
nested dicts of tensors. ``apply_cnn`` takes NHWC images (B, 32, 32, 3),
as the reference does, and computes in NCHW; before the first FC it
restores the reference's feature order (``_grouped_flatten``), so dense
weights carry over unchanged.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (batchnorm_apply, batchnorm_init,
                                       conv2d_apply, conv2d_init,
                                       dense_apply, dense_init,
                                       grouped_dense_apply,
                                       grouped_dense_init, groupnorm_apply,
                                       groupnorm_init)
from repro_torch.models.module import tree_map

# conv plans: ("c", out) 3x3 conv, ("p",) 2x2 maxpool, ("dw", out,
# stride) depthwise-separable block (3x3 depthwise, then 1x1 pointwise)
VGG9_PLAN = (("c", 32), ("c", 64), ("p",), ("c", 128), ("c", 128), ("p",),
             ("c", 256), ("c", 256), ("p",))
VGG16_PLAN = (("c", 64), ("c", 64), ("p",),
              ("c", 128), ("c", 128), ("p",),
              ("c", 256), ("c", 256), ("c", 256), ("p",),
              ("c", 512), ("c", 512), ("c", 512), ("p",),
              ("c", 512), ("c", 512), ("c", 512), ("p",))
MOBILENET_PLAN = (("c", 32),
                  ("dw", 64, 1), ("dw", 128, 2), ("dw", 128, 1),
                  ("dw", 256, 2), ("dw", 256, 1), ("dw", 512, 2),
                  ("dw", 512, 1), ("dw", 512, 1), ("dw", 512, 1),
                  ("dw", 512, 1), ("dw", 512, 1), ("dw", 1024, 2),
                  ("dw", 1024, 1))


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    arch_id: str
    plan: tuple = VGG9_PLAN
    fc_dims: tuple = (512, 512)
    n_classes: int = 10
    norm: str = "none"            # none | bn | gn
    fed2_groups: int = 0
    decouple: int = 6             # trailing weight layers grouped
    input_hw: int = 32
    gn_groups: int = 8
    dtype: torch.dtype = torch.float32
    # PAN alignment: scale of fixed per-channel position encodings added
    # to hidden pre-activations (arxiv 2203.14666); 0.0 adds none
    pan: float = 0.0

    def round_ch(self, c: int) -> int:
        g = self.fed2_groups
        return c if g == 0 else -(-c // g) * g

    @property
    def n_weight_layers(self) -> int:
        convs = sum(1 for s in self.plan if s[0] != "p")
        return convs + len(self.fc_dims) + 1  # + logit layer

    def layer_grouped(self, widx: int) -> bool:
        if self.fed2_groups == 0:
            return False
        return widx >= self.n_weight_layers - self.decouple

    @property
    def is_mobilenet(self) -> bool:
        return "mobilenet" in self.arch_id or "mbnet" in self.arch_id


@dataclasses.dataclass(frozen=True)
class LayerMeta:
    """Fields in the reference's order (``stride`` third); the port
    builds them by keyword."""
    kind: str          # "c" | "dw" | "fc" | "logits"
    groups: int        # feature_group_count / block count (1 = dense)
    stride: int = 1
    c_in: int = 0
    c_out: int = 0
    grouped_fc: bool = False


def layer_meta(cfg: CNNConfig) -> list[LayerMeta]:
    """Static per-weight-layer topology (convs, then FCs, then logits)."""
    metas: list[LayerMeta] = []
    c_in, widx, hw = 3, 0, cfg.input_hw
    g = max(cfg.fed2_groups, 1)
    for step in cfg.plan:
        if step[0] == "p":
            hw //= 2
            continue
        if step[0] not in ("c", "dw"):
            raise ValueError(f"plan step {step!r}: expected a 3x3 conv "
                             "('c'), a depthwise-separable block ('dw') "
                             "or a 2x2 pool ('p')")
        c_out = cfg.round_ch(step[1])
        grouped = cfg.layer_grouped(widx) and c_in % g == 0 and g > 1
        stride = step[2] if step[0] == "dw" else 1
        metas.append(LayerMeta(step[0], g if grouped else 1, stride=stride,
                               c_in=c_in, c_out=c_out))
        if step[0] == "dw" and stride > 1:
            hw = -(-hw // stride)
        c_in, widx = c_out, widx + 1
    d_in = c_in if cfg.is_mobilenet else hw * hw * c_in
    for d in cfg.fc_dims:
        d_out = cfg.round_ch(d)
        grouped = cfg.layer_grouped(widx) and d_in % g == 0 and g > 1
        metas.append(LayerMeta("fc", g if grouped else 1, c_in=d_in,
                               c_out=d_out, grouped_fc=grouped))
        d_in, widx = d_out, widx + 1
    n_cls = cfg.round_ch(cfg.n_classes)
    grouped = cfg.layer_grouped(widx) and d_in % g == 0 and g > 1
    metas.append(LayerMeta("logits", g if grouped else 1, c_in=d_in,
                           c_out=n_cls, grouped_fc=grouped))
    return metas


def conv_metas(metas) -> list:
    """The conv layers' metas ("c" and "dw"), in plan order."""
    return [m for m in metas if m.kind in ("c", "dw")]


def fc_metas(metas) -> list:
    """The dense layers' metas ("fc" and "logits"), in order."""
    return [m for m in metas if m.kind in ("fc", "logits")]


def init_cnn(generator: torch.Generator, cfg: CNNConfig, device=None):
    """Parameters drawn from ``generator`` (a CPU torch.Generator), moved
    to ``device``."""
    convs, fcs = [], []
    for m in layer_meta(cfg):
        if m.kind in ("c", "dw"):
            if m.kind == "dw":   # the reference's {"dw", "w", "norm"}
                layer = {"dw": conv2d_init(generator, m.c_in, m.c_in, 3,
                                           groups=m.c_in, dtype=cfg.dtype),
                         "w": conv2d_init(generator, m.c_in, m.c_out, 1,
                                          groups=m.groups,
                                          dtype=cfg.dtype)}
            else:
                layer = conv2d_init(generator, m.c_in, m.c_out, 3,
                                    groups=m.groups, dtype=cfg.dtype)
            if cfg.norm == "bn":
                layer["norm"] = batchnorm_init(m.c_out, cfg.dtype)
            elif cfg.norm == "gn":
                layer["norm"] = groupnorm_init(m.c_out, cfg.dtype)
            convs.append(layer)
        elif m.grouped_fc:
            fcs.append(grouped_dense_init(generator, m.groups, m.c_in,
                                          m.c_out, bias=True,
                                          dtype=cfg.dtype))
        else:
            fcs.append(dense_init(generator, m.c_in, m.c_out, bias=True,
                                  dtype=cfg.dtype))
    params = {"convs": convs, "fcs": fcs}
    if device is not None:
        params = tree_map(lambda t: t.to(device), params)
    return params


def norm_groups(cfg: CNNConfig, channels: int) -> int:
    """GroupNorm group count: fed2_groups if set (else gn_groups), or 1
    when that does not divide the channels."""
    groups = cfg.fed2_groups if cfg.fed2_groups else cfg.gn_groups
    return 1 if channels % groups else groups


def _apply_norm(cfg, layer, x):
    if "norm" not in layer:
        return x
    if cfg.norm == "bn":
        return batchnorm_apply(layer["norm"], x)
    return groupnorm_apply(layer["norm"], x,
                           groups=norm_groups(cfg, x.shape[1]))


def pan_encoding(n: int, widx: int, scale: float, dtype=torch.float32,
                 device=None):
    """Fixed per-channel position encoding of weight layer ``widx``
    (PAN, arxiv 2203.14666): ``scale * sin(0.5*c + 0.7*widx)`` over
    channel index c, identical on every client."""
    pos = torch.arange(n, dtype=torch.float32, device=device)
    return (scale * torch.sin(0.5 * pos + 0.7 * widx)).to(dtype)


def _grouped_flatten(x, g: int):
    """NCHW (B, C, H, W) -> (B, G * H*W*C/G) in the reference's NHWC
    group-contiguous order: (B, H, W, G, C/G) -> (B, G, H, W, C/G)."""
    b, c, h, w = x.shape
    xg = x.reshape(b, g, c // g, h, w).permute(0, 1, 3, 4, 2)
    return xg.reshape(b, g * h * w * (c // g))


def conv_block(layer, m: LayerMeta, x):
    """A conv layer's convolutions, before its norm: a 3x3 conv, or a
    depthwise-separable block (3x3 depthwise at the layer's stride,
    ReLU, grouped 1x1 pointwise)."""
    if m.kind == "dw":
        x = torch.relu(conv2d_apply(layer["dw"], x, stride=m.stride,
                                    groups=m.c_in))
        return conv2d_apply(layer["w"], x, groups=m.groups)
    return conv2d_apply(layer, x, stride=m.stride, groups=m.groups)


def flatten_features(cfg: CNNConfig, x):
    """The conv trunk's NCHW output -> the first dense layer's input:
    MobileNet's global mean pool, else the reference's flatten order."""
    if cfg.is_mobilenet:
        return x.mean(dim=(2, 3))
    g = max(cfg.fed2_groups, 1)
    if cfg.fed2_groups and x.shape[1] % g == 0:
        return _grouped_flatten(x, g)
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def apply_cnn(params, cfg: CNNConfig, x):
    """x: (B, H, W, 3) NHWC images -> logits (B, n_classes)."""
    metas = layer_meta(cfg)
    convs, fcs = conv_metas(metas), fc_metas(metas)
    x = x.permute(0, 3, 1, 2)
    ci = 0
    for step in cfg.plan:
        if step[0] == "p":
            x = F.max_pool2d(x, 2)
            continue
        layer = params["convs"][ci]
        x = conv_block(layer, convs[ci], x)
        x = _apply_norm(cfg, layer, x)
        if cfg.pan:       # PAN anchor on the pre-activation
            x = x + pan_encoding(x.shape[1], ci, cfg.pan, x.dtype,
                                 x.device).reshape(1, -1, 1, 1)
        x = torch.relu(x)
        ci += 1
    x = flatten_features(cfg, x)
    for i, (m, fc) in enumerate(zip(fcs, params["fcs"])):
        x = (grouped_dense_apply if m.grouped_fc else dense_apply)(fc, x)
        if m.kind != "logits":
            if cfg.pan:   # hidden FCs only
                x = x + pan_encoding(x.shape[-1], ci + i, cfg.pan, x.dtype,
                                     x.device)
            x = torch.relu(x)
    return x[:, :cfg.n_classes]


def cnn_loss(params, cfg: CNNConfig, batch):
    """Mean cross-entropy of the batch's labels."""
    logits = apply_cnn(params, cfg, batch["images"])
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    gold = torch.gather(logp, -1, batch["labels"].long()[:, None])[:, 0]
    return -gold.mean()


def cnn_accuracy(params, cfg: CNNConfig, batch):
    logits = apply_cnn(params, cfg, batch["images"])
    return (logits.argmax(-1) == batch["labels"].long()).to(
        torch.float32).mean()
