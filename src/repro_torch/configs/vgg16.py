"""VGG16 on CIFAR-100 (paper Table 1 bottom / Fig. 8)."""
from repro_torch.models.cnn import VGG16_PLAN, CNNConfig


def full(n_classes=100, norm="gn", fed2_groups=10, decouple=6, **kw):
    return CNNConfig(arch_id="vgg16", plan=VGG16_PLAN, fc_dims=(512, 512),
                     n_classes=n_classes, norm=norm, fed2_groups=fed2_groups,
                     decouple=decouple, **kw)


def baseline(n_classes=100, norm="none", **kw):
    return CNNConfig(arch_id="vgg16", plan=VGG16_PLAN, fc_dims=(512, 512),
                     n_classes=n_classes, norm=norm, fed2_groups=0, **kw)


def reduced(n_classes=10, norm="gn", fed2_groups=5, decouple=3, **kw):
    plan = (("c", 20), ("p",), ("c", 40), ("p",), ("c", 40), ("p",))
    return CNNConfig(arch_id="vgg16-reduced", plan=plan, fc_dims=(80,),
                     n_classes=n_classes, norm=norm, fed2_groups=fed2_groups,
                     decouple=decouple, **kw)
