"""Scenario runner CLI: execute any subset of the fl/scenarios.py
registry and write one ConvergenceRecord JSON per scenario
(``scenario_<name>.json``).

Runs on the CUDA card unless ``--device cpu`` is given. Records go to
``runs_torch/`` at the repository root by default (git ignores it): the
JAX package's committed records in ``benchmarks/artifacts_perf/`` are
never written.

  PYTHONPATH=src python -m repro_torch.launch.scenarios --list
  PYTHONPATH=src python -m repro_torch.launch.scenarios --scenarios all
  PYTHONPATH=src python -m repro_torch.launch.scenarios \\
      --scenarios nxc2_fed2,nxc2_fedma --mesh host
  # a registered scenario at reduced extent, on the CPU
  PYTHONPATH=src python -m repro_torch.launch.scenarios \\
      --scenarios nxc2_fed2 --rounds 2 --train-size 600 --device cpu
"""
from __future__ import annotations

import argparse
import os

from repro_torch.fl import scenarios as scenarios_lib

DEFAULT_OUT = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "runs_torch"))


def run_many(names, *, mesh_kind: str = "none", outdir: str = DEFAULT_OUT,
             rounds: int | None = None, train_size: int | None = None,
             device=None, verbose: bool = True) -> list:
    """Run the named scenarios (optionally at overridden extent) on
    ``device`` (None = the CUDA card) and return their
    ConvergenceRecords; each is written to ``outdir``. ``mesh_kind``
    "host" runs them on the (1, 1) host mesh (``make_host_mesh``), the
    same run as "none"."""
    from repro_torch.fl.runtime import resolve_device
    device = resolve_device(device)
    mesh = None
    if mesh_kind == "host":
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh()
    elif mesh_kind != "none":
        raise ValueError(f"mesh_kind {mesh_kind!r}: 'none' or 'host'")
    overrides = {}
    if rounds is not None:
        overrides["rounds"] = rounds
    if train_size is not None:
        overrides["train_size"] = train_size
        overrides["test_size"] = max(train_size // 4, 64)
    recs = []
    for name in names:
        spec = scenarios_lib.get(name)
        if overrides:
            spec = spec.override(**overrides)
        rec = scenarios_lib.run_scenario(spec, mesh=mesh, device=device,
                                         outdir=outdir)
        recs.append(rec)
        if verbose:
            print(f"[ok] {name:14s} {spec.protocol_label():14s} "
                  f"{spec.method:8s} final {rec.final_acc:.4f} "
                  f"best {rec.best_acc:.4f} wall {rec.wall_total:.1f}s")
    return recs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenarios", default="all",
                    help="comma list from "
                         f"{','.join(scenarios_lib.available())} or 'all'")
    ap.add_argument("--mesh", default="none", choices=["none", "host"],
                    help="host: run rounds + eval tiles on the (1, 1) "
                         "host mesh (the same run as none)")
    ap.add_argument("--rounds", type=int, default=None,
                    help="override every chosen spec's round count "
                         "(smoke runs)")
    ap.add_argument("--train-size", type=int, default=None,
                    help="override train set size (test follows at 1/4)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default=None,
                    help="torch device; default = the CUDA card (fails "
                         "without one), 'cpu' to run on the CPU")
    ap.add_argument("--list", action="store_true",
                    help="print the registry and exit")
    args = ap.parse_args(argv)

    if args.list:
        for name in scenarios_lib.available():
            s = scenarios_lib.get(name)
            print(f"{name:14s} {s.protocol_label():14s} {s.method:8s} "
                  f"{s.summary}")
        return []
    names = (scenarios_lib.available() if args.scenarios == "all"
             else tuple(args.scenarios.split(",")))
    bad = [n for n in names if n not in scenarios_lib.available()]
    if bad:
        raise SystemExit(f"unknown scenarios {bad}; available: "
                         f"{', '.join(scenarios_lib.available())}")
    return run_many(names, mesh_kind=args.mesh, outdir=args.out,
                    rounds=args.rounds,
                    train_size=args.train_size, device=args.device)


if __name__ == "__main__":
    main()
