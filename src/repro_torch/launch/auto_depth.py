"""Fed2's structure adaptation end to end (paper Fig. 10): warm up a
plain model, measure each layer's class preference vectors (Eq. 9) and
their total variance (Eq. 17), decouple from where the TV surges, and
run Fed2 at that depth.

The counterpart of ``examples/auto_depth_fed2.py``, with its constants:
2000 train / 400 test synthetic images at noise 1.2; 40 warm-up steps
of batch 32 with ``sgd(0.01, 0.9)``; Eq. 9 on the first 64 images
through the ``feature_stats`` kernel; ``choose_decouple_depth(
threshold_frac=0.5, min_shared=2)``, at least 1; Fed2 with 5 groups on
6 clients (N x C, 5 classes each), 6 rounds of 8 steps of batch 16 at
lr 0.008.

``--reduced`` is exactly the example (``vgg9.reduced``). The default
runs at full width: ``vgg9.baseline()`` for the warm-up (8 tapped
layers, 32/64/128/128/256/256/512/512 neurons), then
``vgg9.full(fed2_groups=5, decouple=depth)``. Runs on the CUDA card
unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.auto_depth
  PYTHONPATH=src python -m repro_torch.launch.auto_depth --reduced \\
      --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

TRAIN_SIZE, TEST_SIZE, NOISE = 2000, 400, 1.2
WARMUP_STEPS, WARMUP_BATCH, WARMUP_LR = 40, 32, 0.01
PROBE_IMAGES = 64
GROUPS, CLIENTS, CLASSES_PER_NODE = 5, 6, 5
ROUNDS, STEPS, BATCH, LR = 6, 8, 16, 0.008


def model_configs(reduced: bool):
    """(warm-up config, config at decouple depth d as a function of d)."""
    from repro_torch.configs import vgg9
    if reduced:
        return (vgg9.reduced(fed2_groups=0, norm="none"),
                lambda d: vgg9.reduced(fed2_groups=GROUPS, decouple=d,
                                       norm="gn"))
    return (vgg9.baseline(),
            lambda d: vgg9.full(fed2_groups=GROUPS, decouple=d))


def warmup(params, cfg, ds, steps: int, device):
    """``steps`` momentum-SGD steps of batch 32 on one model, over the
    engine's flat layout; batches drawn from ``default_rng(0)`` as in
    the example. Returns the trained params tree (views of one flat
    vector)."""
    from repro_torch.models.cnn import cnn_loss
    from repro_torch.models.module import FlatLayout
    from repro_torch.optim.optimizers import sgd

    layout = FlatLayout(params)
    flat = layout.flatten(params)
    opt = sgd(WARMUP_LR, 0.9)
    state = opt.init(flat)
    grad_fn = torch.func.grad(
        lambda row, b: cnn_loss(layout.unflatten(row), cfg, b))
    rng = np.random.default_rng(0)
    for _ in range(steps):
        sel = rng.integers(0, len(ds.labels), WARMUP_BATCH)
        batch = {"images": torch.as_tensor(ds.images[sel], device=device),
                 "labels": torch.as_tensor(ds.labels[sel], device=device)}
        flat, state = opt.update(grad_fn(flat, batch), state, flat)
    return layout.unflatten(flat)


def run_auto_depth(*, reduced: bool = False, device=None,
                   init_params=None, warmup_steps: int = WARMUP_STEPS,
                   rounds: int = ROUNDS, log=None) -> dict:
    """The workflow above. ``init_params(cfg)`` gives a model's initial
    params tree (e.g. a reference init converted by
    ``repro_torch.convert``); None draws them from
    ``torch.Generator().manual_seed(0)``. Eq. 9 runs through the
    ``feature_stats`` kernel (its plain version on the CPU).

    Returns {warm_cfg, warm_params, probe (images, labels on the device),
    tvs, depth, cfg, history}: ``history`` is ``run_federated``'s."""
    from repro_torch.core.feature_stats import (class_preference_vectors,
                                                total_variance)
    from repro_torch.core.grouping import choose_decouple_depth
    from repro_torch.data.synthetic import make_image_dataset, nxc_partition
    from repro_torch.fl.runtime import (FLConfig, cnn_task, resolve_device,
                                        run_federated)
    from repro_torch.models.cnn import init_cnn
    from repro_torch.models.module import tree_map

    device = resolve_device(device)
    if init_params is None:
        def init_params(cfg):
            return init_cnn(torch.Generator().manual_seed(0), cfg)
    ds = make_image_dataset(TRAIN_SIZE, n_classes=10, seed=0, noise=NOISE)
    test = make_image_dataset(TEST_SIZE, n_classes=10, seed=99, noise=NOISE)

    # 1. warm up a plain model briefly (the paper's short pretrain)
    warm_cfg, fed2_cfg = model_configs(reduced)
    p0 = tree_map(lambda t: torch.as_tensor(t).to(device),
                  init_params(warm_cfg))
    warm = warmup(p0, warm_cfg, ds, warmup_steps, device)

    # 2. TV profile -> decouple depth (Eq. 17 + Fig. 10 threshold rule)
    probe = (torch.as_tensor(ds.images[:PROBE_IMAGES], device=device),
             torch.as_tensor(ds.labels[:PROBE_IMAGES], device=device))
    pvecs = class_preference_vectors(warm, warm_cfg, *probe,
                                     use_kernel=True)
    tvs = [float(total_variance(v)) for v in pvecs]
    depth = max(choose_decouple_depth(tvs, threshold_frac=0.5,
                                      min_shared=2), 1)
    if log:
        log(f"TV profile: {[f'{t:.4f}' for t in tvs]} -> decouple {depth}")

    # 3. Fed2 at the chosen depth
    cfg = fed2_cfg(depth)
    parts = nxc_partition(ds.labels, CLIENTS, CLASSES_PER_NODE, 10, seed=1)
    fl = FLConfig(population=CLIENTS, rounds=rounds, local_epochs=1,
                  steps_per_epoch=STEPS, batch_size=BATCH, lr=LR,
                  momentum=0.9, method="fed2")
    h = run_federated(
        cnn_task(cfg), fl, parts,
        lambda s: {"images": ds.images[s], "labels": ds.labels[s]},
        [{"images": test.images, "labels": test.labels}], log=log,
        device=device, init_params=init_params(cfg))
    if log:
        log(f"auto-depth fed2 accs: {['%.3f' % a for a in h['acc']]}")
    return {"warm_cfg": warm_cfg, "warm_params": warm, "probe": probe,
            "tvs": tvs, "depth": depth, "cfg": cfg, "history": h}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reduced", action="store_true",
                    help="the example's reduced VGG9 (default: full "
                         "width)")
    ap.add_argument("--device", default=None,
                    help="torch device; default = the CUDA card (fails "
                         "without one), 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    return run_auto_depth(reduced=args.reduced, device=args.device,
                          log=print)


if __name__ == "__main__":
    main()
