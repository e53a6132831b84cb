"""End-to-end run of the paper's scenario: federated image
classification under non-IID skew, Fed2 vs any set of registered methods
(``fl/methods.py``; ``--methods all`` runs the whole registry), with the
population decoupled from the per-round cohort (``fl/population.py``):
``--population`` logical clients, of which ``--cohort-size`` train each
round under the ``--sampler`` participation strategy. The port of the
reference's ``examples/fed2_cifar_fl.py``, with its flags and defaults.

  PYTHONPATH=src python -m repro_torch.examples.fed2_cifar_fl
  PYTHONPATH=src python -m repro_torch.examples.fed2_cifar_fl \\
      --methods all --rounds 3 --device cpu

Every method fuses on the card through ``run_federated``'s round engine,
whose kernel route is ``paired_fusion`` (one launch a round; fedma fuses
on the host). ``--mesh host`` runs the rounds on the reference's (1, 1)
host mesh (``launch.mesh.make_host_mesh``): one device, so the same run
as ``--mesh none``, the fusion kernel kept.
"""
from __future__ import annotations

import argparse

N_CLASSES, GROUPS = 10, 5


def model_config(method: str):
    """The reduced VGG9 a method trains: Fed2's grouped, GroupNorm net
    for group-structured methods, else the plain one."""
    from repro_torch.configs import vgg9
    from repro_torch.fl import methods as methods_lib
    if methods_lib.get(method).uses_groups:
        return vgg9.reduced(fed2_groups=GROUPS, decouple=3, norm="gn")
    return vgg9.reduced(fed2_groups=0, norm="none")


def held_out_batches(noise: float = 1.6) -> list:
    """The eval set: 600 images of the same classes."""
    from repro_torch.data.synthetic import make_image_dataset
    ims = make_image_dataset(600, n_classes=N_CLASSES, seed=99, noise=noise)
    return [{"images": ims.images, "labels": ims.labels}]


def run_fed2_cifar_fl(*, rounds: int = 10, population: int = 6,
                      cohort_size: int | None = None, sampler: str = "full",
                      mesh: str = "none", classes_per_node: int = 5,
                      noise: float = 1.6, methods: str = "fedavg,fed2",
                      device=None, init_params=None, log=print) -> dict:
    """Each method's ``run_federated`` history, by name. ``init_params(
    cfg)`` gives a model's initial params tree (e.g. the reference's
    ``PRNGKey(0)`` init through ``repro_torch.convert``); None draws one
    from the run's seed."""
    from repro_torch.data.synthetic import make_image_dataset, nxc_partition
    from repro_torch.fl import methods as methods_lib
    from repro_torch.fl.runtime import (FLConfig, cnn_task, resolve_device,
                                        run_federated)
    from repro_torch.launch.mesh import make_host_mesh
    placement = make_host_mesh() if mesh == "host" else None
    device = resolve_device(device)
    ds = make_image_dataset(3000, n_classes=N_CLASSES, seed=0, noise=noise)
    parts = nxc_partition(ds.labels, population, classes_per_node,
                          N_CLASSES, seed=1)

    def get_batch(sel):
        return {"images": ds.images[sel], "labels": ds.labels[sel]}

    test_batches = held_out_batches(noise)
    chosen = (methods_lib.available() if methods == "all"
              else methods.split(","))
    results = {}
    for method in chosen:
        cfg = model_config(method)
        fl = FLConfig(population=population, cohort_size=cohort_size,
                      sampler=sampler, rounds=rounds, local_epochs=1,
                      steps_per_epoch=6, batch_size=16, lr=0.015,
                      momentum=0.9, method=method, seed=0)
        if log:
            log(f"=== {method} (population {fl.population}, cohort "
                f"{fl.cohort_size}, sampler {fl.sampler}) ===")
        results[method] = run_federated(
            cnn_task(cfg), fl, parts, get_batch, test_batches, log=log,
            device=device, mesh=placement,
            init_params=None if init_params is None else init_params(cfg))
    return results


def group_accuracies(results: dict) -> dict:
    """Final-round per-group accuracy (``fl/evaluation.py``'s confusion
    counts): group g is scored over the eval samples whose label is in
    its logit signature, Eq. 19's pairing key."""
    from repro_torch.core.grouping import GroupSpec
    from repro_torch.fl.evaluation import group_accuracy
    spec = GroupSpec.contiguous(GROUPS, N_CLASSES)
    return {m: group_accuracy(h["confusion"][-1], spec)
            for m, h in results.items()}


def main(argv=None):
    from repro_torch.fl import methods as methods_lib
    from repro_torch.fl import population as population_lib
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--population", type=int, default=6,
                    help="logical clients behind the run")
    ap.add_argument("--cohort-size", type=int, default=None,
                    help="participants per round (engine width); "
                         "default = the full population")
    ap.add_argument("--sampler", default="full",
                    choices=list(population_lib.available()))
    ap.add_argument("--mesh", default="none", choices=["none", "host"],
                    help="host: the cohort axis placed on the (1, 1) "
                         "host mesh")
    ap.add_argument("--classes-per-node", type=int, default=5)
    ap.add_argument("--noise", type=float, default=1.6)
    ap.add_argument("--methods", default="fedavg,fed2",
                    help="comma list from "
                         f"{','.join(methods_lib.available())}, or 'all'")
    ap.add_argument("--device", default=None,
                    help="torch device; default = the CUDA card (fails "
                         "without one), 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    results = run_fed2_cifar_fl(
        rounds=args.rounds, population=args.population,
        cohort_size=args.cohort_size, sampler=args.sampler, mesh=args.mesh,
        classes_per_node=args.classes_per_node, noise=args.noise,
        methods=args.methods, device=args.device)

    print("\nmethod, best_acc, final_acc, acc_curve")
    for m, h in results.items():
        accs = h["acc"]
        print(f"{m}, {max(accs):.4f}, {accs[-1]:.4f}, "
              f"{['%.3f' % a for a in accs]}")
    print("\nper-group accuracy (final round, groups of "
          f"{N_CLASSES // GROUPS} classes):")
    for m, ga in group_accuracies(results).items():
        print(f"{m}, {['%.3f' % a for a in ga]}")
    return results


if __name__ == "__main__":
    main()
