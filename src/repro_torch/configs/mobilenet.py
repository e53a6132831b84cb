"""MobileNetV1 on CIFAR-10 (paper Tables 1-2, 'MbNet')."""
from repro_torch.models.cnn import MOBILENET_PLAN, CNNConfig


def full(n_classes=10, norm="gn", fed2_groups=10, decouple=6, **kw):
    return CNNConfig(arch_id="mobilenet", plan=MOBILENET_PLAN, fc_dims=(),
                     n_classes=n_classes, norm=norm, fed2_groups=fed2_groups,
                     decouple=decouple, **kw)


def baseline(n_classes=10, norm="none", **kw):
    return CNNConfig(arch_id="mobilenet", plan=MOBILENET_PLAN, fc_dims=(),
                     n_classes=n_classes, norm=norm, fed2_groups=0, **kw)


def reduced(n_classes=10, norm="gn", fed2_groups=5, decouple=3, **kw):
    plan = (("c", 20), ("dw", 40, 2), ("dw", 40, 1), ("dw", 80, 2))
    return CNNConfig(arch_id="mobilenet-reduced", plan=plan, fc_dims=(),
                     n_classes=n_classes, norm=norm, fed2_groups=fed2_groups,
                     decouple=decouple, **kw)
