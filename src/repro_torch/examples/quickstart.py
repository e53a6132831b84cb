"""Quickstart: the Fed2 workflow in ~60 lines. The port of the
reference's ``examples/quickstart.py``.

1. Build a Fed2-adapted model (group conv + decoupled logits + GN).
2. Inspect its feature allocation (class preference vectors, Eq. 9).
3. Run two simulated clients and fuse with feature paired averaging (Eq. 19).

  PYTHONPATH=src python -m repro_torch.examples.quickstart
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

Eq. 9 and the fusion take their plain routes, as the reference's
example does (``use_kernel=False``, both functions' default): no kernel
launches. The two clients sit as rows of one (2, M) ``FlatLayout``
buffer, which ``paired_average`` fuses.
"""
from __future__ import annotations

import argparse

import torch


def run_quickstart(*, device=None, init_params=None) -> dict:
    """The example's three steps. ``init_params(cfg)`` gives the initial
    params tree (e.g. the reference's ``PRNGKey(0)`` init through
    ``repro_torch.convert``); None draws it from
    ``torch.Generator().manual_seed(0)``. Returns {classes_per_group,
    tvs, loss, params}: ``params`` the fused global tree."""
    from repro_torch.configs import vgg9
    from repro_torch.core import feature_stats, fusion
    from repro_torch.core.grouping import GroupSpec
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.fl.runtime import resolve_device
    from repro_torch.models.cnn import cnn_loss, init_cnn
    from repro_torch.models.module import FlatLayout, tree_map

    device = resolve_device(device)
    # 1. Fed2 structure adaptation: 5 groups over 10 classes, last 3
    #    layers decoupled, GroupNorm (paper §5.1)
    cfg = vgg9.reduced(fed2_groups=5, decouple=3, norm="gn")
    spec = GroupSpec.contiguous(cfg.fed2_groups, cfg.n_classes)
    params = (init_params(cfg) if init_params is not None
              else init_cnn(torch.Generator().manual_seed(0), cfg))
    params = tree_map(lambda t: torch.as_tensor(t).to(device), params)
    ds = make_image_dataset(128, n_classes=10, seed=0)
    images = torch.as_tensor(ds.images, device=device)
    labels = torch.as_tensor(ds.labels, device=device)

    # 2. feature interpretation: per-neuron class preference + layer TV
    #    (Eq. 17)
    pvecs = feature_stats.class_preference_vectors(params, cfg, images[:32],
                                                   labels[:32])
    tvs = [float(feature_stats.total_variance(p)) for p in pvecs]

    # 3. two clients, one local step each, feature-paired fusion
    grad_fn = torch.func.grad(lambda p, b: cnn_loss(p, cfg, b))

    def local_step(p, lo, hi):
        batch = {"images": images[lo:hi], "labels": labels[lo:hi]}
        return tree_map(lambda w, g: w - 0.05 * g, p, grad_fn(p, batch))

    layout = FlatLayout(params)
    stacked = layout.alloc((2,), device=device)
    for row, (lo, hi) in zip(stacked, ((0, 64), (64, 128))):
        layout.flatten(local_step(params, lo, hi), out=row)
    group_axes = fusion.cnn_group_axes(params, cfg)
    global_params = layout.unflatten(
        fusion.paired_average(stacked, layout, group_axes))
    loss = cnn_loss(global_params, cfg,
                    {"images": images[:64], "labels": labels[:64]})
    return {"classes_per_group": spec.classes_per_group, "tvs": tvs,
            "loss": float(loss), "params": global_params}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; default = the CUDA card (fails "
                         "without one), 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    out = run_quickstart(device=args.device)
    print("class->group map:", out["classes_per_group"])
    print("layer TVs:", [f"{t:.4f}" for t in out["tvs"]])
    print(f"fused global loss: {out['loss']:.4f}")
    print("OK — see repro_torch.examples.fed2_cifar_fl for the full "
          "federated loop.")
    return out


if __name__ == "__main__":
    main()
