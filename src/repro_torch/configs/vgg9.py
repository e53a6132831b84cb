"""VGG9 (FedMA variant) on CIFAR-10: the paper's primary testbed."""
from repro_torch.models.cnn import VGG9_PLAN, CNNConfig


def full(n_classes=10, norm="gn", fed2_groups=10, decouple=6, **kw):
    """Fed2-adapted VGG9: last 6 weight layers grouped (paper §6 default)."""
    return CNNConfig(arch_id="vgg9", plan=VGG9_PLAN, fc_dims=(512, 512),
                     n_classes=n_classes, norm=norm, fed2_groups=fed2_groups,
                     decouple=decouple, **kw)


def baseline(n_classes=10, norm="none", **kw):
    """Original (non-grouped) VGG9 for the FedAvg/FedProx baselines."""
    return CNNConfig(arch_id="vgg9", plan=VGG9_PLAN, fc_dims=(512, 512),
                     n_classes=n_classes, norm=norm, fed2_groups=0, **kw)


def reduced(n_classes=10, norm="gn", fed2_groups=5, decouple=3, **kw):
    plan = (("c", 20), ("p",), ("c", 40), ("p",), ("c", 40), ("p",))
    return CNNConfig(arch_id="vgg9-reduced", plan=plan, fc_dims=(80,),
                     n_classes=n_classes, norm=norm, fed2_groups=fed2_groups,
                     decouple=decouple, **kw)
