"""Training launcher. Two modes, as in ``repro.launch.train``:

  --mode lm    : language-model training of the port's LMs
                 (``--arch llama3.2-1b`` or ``mamba2-1.3b``, ``--reduced``
                 or full, ``--fed2`` for the block-diagonal unembedding
                 and, for the dense llama, decoupled grouped-FFN blocks)
                 on the synthetic token corpus: AdamW, ``--microbatches``,
                 ``--ckpt``;
  --mode fl    : the paper's federated scenario (CNN + Fed2/fedavg/...).

Runs on the CUDA card unless ``--device cpu`` is given. ``--mode fl``'s
defaults match
``python -m repro.launch.train --mode fl``: the full VGG9 with 8
structure groups for fed2 (the plain baseline VGG9 for fedavg/fedprox),
10 clients at full participation, 8 momentum-SGD steps of batch 32 per
round, N x C partition with 5 classes per node, 4000 synthetic images.
``--arch vgg16|mobilenet`` picks the paper's other testbeds (VGG16 on
100 classes, MobileNetV1 on 10), and ``--dirichlet ALPHA`` FedMA's
Dir(alpha) label split in place of N x C. The sync round's feature axes
take the JAX CLI's flags: ``--attack``/``--attack-fraction``,
``--robust``, ``--codec``, ``--compute-dtype``, ``--local-unroll``,
``--alignment`` and ``--fed-mode sync|one_shot``;
``--list-capabilities`` prints the method x feature table. Capacity
tiers take ``--tiers`` (fl/capacity.py) and buffered-async federation
``--fed-mode async`` with ``--buffer-k``, ``--staleness`` and
``--latency`` (fl/async_engine.py). ``--store mmap`` keeps the
client state in ``--chunk-size``-row shards on disk
(fl/statestore.py), in sync and async runs.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --mode lm \\
      --arch llama3.2-1b --fed2 --batch 8 --seq 1024 --steps 4
  PYTHONPATH=src python -m repro_torch.launch.train --mode lm \\
      --arch mamba2-1.3b --fed2 --batch 8 --seq 1024 --steps 4
  PYTHONPATH=src python -m repro_torch.launch.train --mode lm \\
      --arch mamba2-1.3b --reduced --steps 50 --batch 8 --seq 128 \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --mode fl \\
      --method fed2 --rounds 10
  PYTHONPATH=src python -m repro_torch.launch.train --mode fl \\
      --method fed2 --use-local-kernel          # fused local_step route
  PYTHONPATH=src python -m repro_torch.launch.train --mode fl \\
      --scenario nxc2_fed2                      # a registered scenario
  PYTHONPATH=src python -m repro_torch.launch.train --mode fl \\
      --arch mobilenet --dirichlet 0.5          # MobileNetV1, Dir(0.5)
  PYTHONPATH=src python -m repro_torch.launch.train --mode fl \\
      --attack 'sign_flip(4)' --attack-fraction 0.2 \\
      --robust 'trimmed_mean(0.25)'             # adversarial + robust
  PYTHONPATH=src python -m repro_torch.launch.train --mode fl \\
      --compute-dtype bfloat16 --use-local-kernel   # bf16 local phase
  PYTHONPATH=src python -m repro_torch.launch.train --mode fl \\
      --method fed2 --fed2-groups 5 --nodes 6 \\
      --tiers 1.0x2,0.6x2,0.2x2                 # capacity tiers
  PYTHONPATH=src python -m repro_torch.launch.train --mode fl \\
      --method fed2 --cohort-size 4 --sampler uniform --fed-mode async \\
      --buffer-k 2 --staleness 'polynomial(0.5)' \\
      --latency 'pareto(1.5)'                   # buffered async
  PYTHONPATH=src python -m repro_torch.launch.train --mode fl \\
      --method fedavg --nodes 100000 --cohort-size 8 --sampler weighted \\
      --store mmap --chunk-size 4096            # client state on disk
  PYTHONPATH=src python -m repro_torch.launch.train --mode fl \\
      --reduced --rounds 2 --train-size 400 --device cpu
"""
from __future__ import annotations

import argparse
import importlib
import time

ARCHS = ("vgg9", "vgg16", "mobilenet")      # --mode fl
LM_ARCHS = ("mamba2-1.3b", "llama3.2-1b")  # --mode lm


def run_lm(args) -> dict:
    """LM training on the synthetic token corpus: ``args.steps`` AdamW
    steps of ``args.batch`` sequences of ``args.seq`` tokens, the
    weights drawn on the run's device from ``args.seed``. Prints the
    loss at the reference's cadence and returns {"loss", "wall" (host
    seconds after each step, its loss read), "tokens_per_step",
    "final_params"}."""
    import torch

    from repro_torch.checkpoint.io import save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.configs.common import with_fed2
    from repro_torch.data.synthetic import (lm_batch_from_tokens,
                                            make_token_dataset)
    from repro_torch.fl.runtime import resolve_device
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.module import tree_map
    from repro_torch.models.transformer import init_params

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.fed2:
        cfg = with_fed2(cfg, groups=args.fed2_groups)
    params = init_params(torch.Generator(device=device).manual_seed(
        args.seed), cfg)
    step_fn, opt = make_train_step(cfg, lr=args.lr,
                                   microbatches=args.microbatches)
    ostate = opt.init(params)
    toks, _ = make_token_dataset(args.batch * args.steps, args.seq + 1,
                                 cfg.vocab, seed=args.seed)
    losses, wall = [], []
    t0 = time.time()
    for i in range(args.steps):
        batch = lm_batch_from_tokens(toks[i * args.batch:(i + 1) * args.batch],
                                     device=device)
        params, ostate, loss = step_fn(params, ostate, i, batch)
        losses.append(float(loss))
        wall.append(time.time() - t0)
        if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss {losses[-1]:.4f} ({wall[-1]:.1f}s)")
    if args.ckpt:
        # numpy has no bfloat16 of its own: bf16 leaves are stored as
        # their (exact) fp32 values
        save_checkpoint(args.ckpt, tree_map(
            lambda t: t.float() if t.dtype == torch.bfloat16 else t,
            params),
            step=args.steps)
        print("checkpoint ->", args.ckpt)
    return {"loss": losses, "wall": wall,
            "tokens_per_step": args.batch * args.seq,
            "final_params": params}


def build_model_config(args, method):
    """The CLI's model, from ``repro_torch.configs.<arch>``, through the
    alignment rule (fl/alignment.py): under "grouped", Fed2 structure
    adaptation for group-structured methods and the plain baseline of
    the same widths otherwise; "pan"/"none" build the plain net."""
    from repro_torch.fl import alignment as alignment_lib
    mod = importlib.import_module(f"repro_torch.configs.{args.arch}")
    return alignment_lib.build_model_config(
        alignment_lib.get(args.alignment), method,
        grouped_fn=lambda: (mod.reduced() if args.reduced
                            else mod.full(fed2_groups=args.fed2_groups)),
        plain_fn=lambda: (mod.reduced(fed2_groups=0, norm="none")
                          if args.reduced else mod.baseline()))


def fl_inputs(args):
    """The run the CLI's flags describe, as ``run_federated``'s
    positional arguments: (task, fl_config, parts, get_batch,
    test_batches)."""
    from repro_torch.data.synthetic import (dirichlet_partition,
                                            make_image_dataset,
                                            nxc_partition)
    from repro_torch.fl import methods as methods_lib
    from repro_torch.fl.runtime import FLConfig, cnn_task

    cfg = build_model_config(args, methods_lib.get(args.method))
    ds = make_image_dataset(args.train_size, n_classes=cfg.n_classes,
                            seed=args.seed, noise=args.noise)
    test = make_image_dataset(args.train_size // 4,
                              n_classes=cfg.n_classes, seed=args.seed + 99,
                              noise=args.noise)
    if args.dirichlet > 0:
        parts = dirichlet_partition(ds.labels, args.nodes, args.dirichlet,
                                    cfg.n_classes, seed=args.seed)
    else:
        parts = nxc_partition(ds.labels, args.nodes, args.classes_per_node,
                              cfg.n_classes, seed=args.seed)

    def get_batch(sel):
        return {"images": ds.images[sel], "labels": ds.labels[sel]}

    test_batches = [{"images": test.images, "labels": test.labels}]
    fl = FLConfig(population=args.nodes, cohort_size=args.cohort_size,
                  sampler=args.sampler, rounds=args.rounds,
                  local_epochs=args.local_epochs,
                  steps_per_epoch=args.steps_per_epoch,
                  batch_size=args.batch, lr=args.lr, momentum=0.9,
                  method=args.method, seed=args.seed,
                  tiers=args.tiers or None, mode=args.fed_mode,
                  buffer_k=args.buffer_k, staleness=args.staleness,
                  store=args.store, chunk_size=args.chunk_size,
                  attack=args.attack or None,
                  attack_fraction=args.attack_fraction,
                  robust=args.robust or None,
                  compute_dtype=args.compute_dtype,
                  codec=args.codec or None,
                  local_unroll=args.local_unroll,
                  alignment=args.alignment)
    return cnn_task(cfg), fl, parts, get_batch, test_batches


def run_fl(args):
    from repro_torch.fl.runtime import resolve_device, run_federated

    if args.list_capabilities:
        from repro_torch.fl import compat as compat_lib
        print(compat_lib.capability_table())
        return None
    device = resolve_device(args.device)
    if args.scenario:
        # a registered scenario IS the full run config (fl/scenarios.py)
        from repro_torch.fl import scenarios as scenarios_lib
        spec = scenarios_lib.get(args.scenario)
        rec = scenarios_lib.run_scenario(
            spec, use_local_kernel=args.use_local_kernel, device=device,
            log=print)
        print(f"scenario {spec.name} ({spec.protocol_label()}, "
              f"{spec.method}): final acc {rec.final_acc:.4f}, "
              f"best {rec.best_acc:.4f}")
        return rec

    h = run_federated(*fl_inputs(args), latency=args.latency, log=print,
                      use_local_kernel=args.use_local_kernel, device=device)
    print("final acc:", h["acc"][-1])
    return h


def parse_args(argv=None):
    """The CLI's flags (``argv=None`` reads ``sys.argv``)."""
    from repro_torch.fl import alignment as alignment_lib
    from repro_torch.fl import attacks as attacks_lib
    from repro_torch.fl import codec as codec_lib
    from repro_torch.fl import methods as methods_lib
    from repro_torch.fl import population as population_lib
    from repro_torch.fl import robust as robust_lib
    from repro_torch.fl import statestore as statestore_lib

    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["lm", "fl"], default="fl")
    ap.add_argument("--arch", default="vgg9", choices=ARCHS + LM_ARCHS,
                    help="fl mode: a CNN (" + ", ".join(ARCHS) + "); lm "
                         "mode: an LM (" + ", ".join(LM_ARCHS) + ")")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--fed2", action="store_true",
                    help="lm mode: Fed2 structure adaptation (the "
                         "block-diagonal unembedding over --fed2-groups "
                         "vocab clusters)")
    ap.add_argument("--fed2-groups", type=int, default=8)
    ap.add_argument("--method", default="fed2",
                    choices=list(methods_lib.available()))
    ap.add_argument("--scenario", default="",
                    help="run a registered scenario from fl/scenarios.py "
                         "verbatim; overrides the per-knob flags")
    ap.add_argument("--steps", type=int, default=100,
                    help="lm mode: optimizer steps")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--nodes", type=int, default=10,
                    help="logical client population")
    ap.add_argument("--cohort-size", type=int, default=None,
                    help="engine width (participants per tile); default "
                         "= the full population")
    ap.add_argument("--sampler", default="full",
                    choices=list(population_lib.available()))
    ap.add_argument("--store", default="memory",
                    choices=list(statestore_lib.available()),
                    help="client-state store backend: 'memory' stacks "
                         "all P client rows in RAM; 'mmap' keeps them in "
                         "chunked on-disk shards so server memory is "
                         "O(cohort) (fl/statestore.py)")
    ap.add_argument("--chunk-size", type=int, default=1024,
                    help="client rows per on-disk shard for --store mmap")
    ap.add_argument("--tiers", default="",
                    help="heterogeneous capacity tiers as <width>x<count> "
                         "pairs summing to --nodes, e.g. "
                         "1.0x2,0.5x2,0.25x2 (fl/capacity.py; "
                         "group-structured methods need width*G integer)")
    ap.add_argument("--fed-mode", default="sync",
                    choices=["sync", "async", "one_shot"],
                    help="'async' = buffered-async federation "
                         "(fl/async_engine.py): --rounds counts fusion "
                         "events, --cohort-size is the in-flight "
                         "concurrency; 'one_shot' = train the whole round "
                         "budget locally and fuse exactly once "
                         "(fl/runtime.py one_shot_config)")
    ap.add_argument("--buffer-k", type=int, default=None,
                    help="async: updates fused per event (default = the "
                         "cohort size, the sync-equivalent bound)")
    ap.add_argument("--staleness", default="constant",
                    help="async: staleness discount, 'constant' or "
                         "'polynomial(a)'")
    ap.add_argument("--latency", default="zero",
                    help="async: seed-deterministic client-latency trace, "
                         "'zero', 'pareto(a)' or 'lognormal(sigma)'")
    ap.add_argument("--attack", default="",
                    help="byzantine client behavior as name[(param)], "
                         "e.g. label_flip or sign_flip(4) (fl/attacks.py "
                         "registry: " + ", ".join(attacks_lib.available())
                         + ")")
    ap.add_argument("--attack-fraction", type=float, default=0.0,
                    help="attacker share of the population in (0, 1), or "
                         "an explicit count >= 1; assignment is "
                         "seed-deterministic (requires --attack)")
    ap.add_argument("--robust", default="",
                    help="robust fusion rule as name[(param)], e.g. "
                         "coordinate_median or trimmed_mean(0.25) "
                         "(fl/robust.py registry: "
                         + ", ".join(robust_lib.available()) + ")")
    ap.add_argument("--compute-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="local-phase compute dtype; bfloat16 casts at "
                         "the round boundary and fuses in fp32 "
                         "(mixed_precision methods only)")
    ap.add_argument("--codec", default="",
                    help="uplink codec as name[(param)], e.g. 'int8' or "
                         "'topk(0.05)' (fl/codec.py registry: "
                         + ", ".join(codec_lib.available()) + ")")
    ap.add_argument("--local-unroll", type=int, default=1,
                    help="validated and clamped like the JAX CLI's scan "
                         "unroll; eager torch has no scan, so it changes "
                         "neither result nor dispatch")
    ap.add_argument("--alignment", default="grouped",
                    choices=list(alignment_lib.available()),
                    help="feature-alignment strategy (fl/alignment.py): "
                         "'grouped' = the method's own structural "
                         "declaration (the default), 'pan' = PAN position "
                         "encodings on a plain net, 'none' = unaligned "
                         "plain-net control")
    ap.add_argument("--list-capabilities", action="store_true",
                    help="print the method x feature capability table "
                         "(fl/compat.py) and exit")
    ap.add_argument("--use-local-kernel", action="store_true",
                    help="run the local optimizer tail through the fused "
                         "local_step kernel")
    ap.add_argument("--device", default=None,
                    help="torch device; default = the CUDA card (fails "
                         "without one), 'cpu' to run on the CPU")
    ap.add_argument("--classes-per-node", type=int, default=5)
    ap.add_argument("--dirichlet", type=float, default=0.0,
                    help="Dir(alpha) label split (FedMA protocol) when "
                         "> 0; else N x C with --classes-per-node")
    ap.add_argument("--local-epochs", type=int, default=1)
    ap.add_argument("--steps-per-epoch", type=int, default=8)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=128,
                    help="lm mode: tokens per sequence")
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--microbatches", type=int, default=1,
                    help="lm mode: split each batch, accumulating grads "
                         "in fp32")
    ap.add_argument("--train-size", type=int, default=4000)
    ap.add_argument("--noise", type=float, default=1.2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default="",
                    help="lm mode: save the final params here "
                         "(checkpoint/io.py's format)")
    args = ap.parse_args(argv)
    check_mode_flags(ap, args)
    return args


def check_mode_flags(ap, args) -> None:
    """The reference's refusals of fl-only flags outside --mode fl (its
    messages), and the arch each mode takes."""
    if args.list_capabilities:
        return
    if args.scenario and args.mode != "fl":
        ap.error("--scenario is only supported with --mode fl")
    if args.tiers and args.mode != "fl":
        ap.error("--tiers is only supported with --mode fl")
    if args.mode != "fl" and (args.fed_mode != "sync"
                              or args.buffer_k is not None
                              or args.staleness != "constant"
                              or args.latency != "zero"):
        ap.error("--fed-mode/--buffer-k/--staleness/--latency are only "
                 "supported with --mode fl")
    if args.mode != "fl" and (args.attack or args.attack_fraction
                              or args.robust):
        ap.error("--attack/--attack-fraction/--robust are only supported "
                 "with --mode fl")
    if args.mode != "fl" and (args.compute_dtype != "float32"
                              or args.codec or args.local_unroll != 1
                              or args.use_local_kernel):
        ap.error("--compute-dtype/--codec/--local-unroll/"
                 "--use-local-kernel are only supported with --mode fl")
    if args.mode != "fl" and args.alignment != "grouped":
        ap.error("--alignment is only supported with --mode fl")
    archs = LM_ARCHS if args.mode == "lm" else ARCHS
    if args.arch not in archs:
        ap.error(f"--mode {args.mode} takes --arch "
                 + "|".join(archs) + f", got {args.arch!r}")


def main(argv=None):
    args = parse_args(argv)
    lm = args.mode == "lm" and not args.list_capabilities
    return (run_lm if lm else run_fl)(args)


if __name__ == "__main__":
    main()
