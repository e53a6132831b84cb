"""Dry-run of the FEDERATED round on the production (or host) mesh: does
the round build at full size, and what must each device hold? The
port's record of the reference's ``repro.launch.fl_dryrun``, through the
same round engine (fl/engine.py) that serves real runs. No memory is
ever allocated: every tensor lives on ``meta``.

The reference lowers and compiles each program with XLA on 512 fake
devices: the stacked client params with their leading client axis on
mesh axis "data", the local steps vmapped over the clients, the fusion
one all-reduce over "data", and a host-fusion method (fedma) ending its
device program at the stacked params. The port answers the same
questions without devices:

- **builds** (``lower_s``): the engine, the state, the flat global
  params, the batches, the weights (and fed2's presence rows, an
  attack's malicious row and key) on ``meta``, each beside the
  reference's placement (``fl/engine.lower_round``,
  ``fl/capacity.lower_tier_tile``, ``fl/async_engine.lower_async_event``);
- **runs** (``compile_s``): the program once on those meta tensors under
  ``torch.utils.flop_counter.FlopCounterMode``, on the plain routes (no
  kernel accepts a meta tensor), with a data-flow trace that checks
  which arguments it reads;
- **fits**: each device's bytes of the arguments the program reads and
  of its outputs, exactly;
- **moves** (``collectives``): what one rank issues of the port's own
  rank program, by XLA's kinds: the same case built a second time on
  rank 0 of a dry mesh (``fl/engine.RankStep``), run once on meta, its
  collectives counted and moved nowhere (``launch/collectives.py``'s
  no-wire branch).

Every method of the fl/methods.py registry x both families (the
VGG9 CNN and the reduced llama3.2-1b), plus the capacity-tier tiles
(``--tiers``), the async fusion events (``--async-events``), one
sign_flip-poisoned round per fusion family under a reducing robust rule
(``ROBUST_MATRIX``), one bf16 + compressed-uplink round per fusion
family (``FAST_MATRIX``, with the codec's uplink bytes) and one
PAN-aligned round (``ALIGN_MATRIX``): 31 records a mesh, fedma x lm
``skipped``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.fl_dryrun       # 16x16
  PYTHONPATH=src python -m repro_torch.launch.fl_dryrun --mesh host \\
      --clients 4 --local-steps 2 --batch 8 --seq 32           # 1x1

Records land in ``runs_torch/fl_dryrun/dryrun_<tag>.json`` (``--out``);
the CLI exits 1 when any record is an ``error``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch.fl import compat as compat_lib
from repro_torch.fl import methods as methods_lib
from repro_torch.fl import population as population_lib
from repro_torch.fl.engine import (lower_round, param_shapes,
                                   stacked_param_bytes, traced_reads)
from repro_torch.fl.runtime import FLConfig, cnn_task, lm_task
from repro_torch.launch import sharding as shd
from repro_torch.launch.collectives import XLA_KINDS, Counts
from repro_torch.launch.collectives import by_xla_kind as collectives
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.module import tree_leaves

FAMILIES = ("cnn", "lm")
DEFAULT_OUT = "runs_torch/fl_dryrun"
ROUTE = "plain (use_kernel=False): no kernel takes a meta tensor"

# what the torch record holds where the reference's holds XLA's numbers
NOTES = {
    "flops": "torch.utils.flop_counter.FlopCounterMode's count of the "
             "whole global program on the plain routes: every client's "
             "every local step, the fusion and the server step "
             "(matmuls and convolutions; elementwise ops count 0, so an "
             "async event counts 0). Under the round's vmap(grad) the "
             "mode counts a convolution's weight gradient as one "
             "ungrouped convolution over the whole cohort, C times what "
             "the same gradients cost client by client, so the CNN "
             "rounds' counts overstate their work; matmuls and "
             "forwards count as a loop over the clients would. The "
             "reference's 'flops' is XLA's per-device cost_analysis() "
             "of its compiled program, which counts a scanned step "
             "once: compare the two as a ratio.",
    "memory": "argument_bytes: one device's share of the arguments the "
              "program reads, under the reference's placement (the "
              "leading client axis on 'data', everything else "
              "replicated; an async event's (K, M) rows on 'data' only "
              "when K divides it). jit drops an argument its program "
              "never reads, and so does this count: the weights of a "
              "host-fusion round (fedma's device program ends at the "
              "stacked params), the key of an attack that draws no "
              "noise, and an async event's global params where its "
              "fuse and server step ignore them (fed2, fedavg). The "
              "meta pass checks the declared reads of the meta "
              "arguments against a data-flow trace; the attack's row "
              "and key are host values, counted at the reference's "
              "shapes ((C,) float32, (2,) 4-byte ints). Flat tensors "
              "count by their (C, M) views, not FlatLayout's row "
              "padding. output_bytes: the outputs' share plus "
              "output_table_bytes, the index XLA keeps for an output "
              "tuple, 8 bytes per leaf of the reference's output tree "
              "when it has more than one. temp_bytes: null, XLA's "
              "buffer assignment has no meta counterpart.",
    "use_kernel": "the fusion route the program takes on the card: the "
                  "caller's choice, the paired_fusion kernel when it "
                  "makes none (make_round_engine's default), off on a "
                  "mesh of more than one device and under a reducing "
                  "robust rule (fl/engine.resolve_use_kernel). The "
                  "reference's default is off on the CPU, so its 1x1 "
                  "records say false.",
    "collectives": "what one rank issues in the port's rank program "
                   "(launch/collectives.py), by XLA's kinds: bytes = its "
                   "result buffers' bytes summed, count = its calls. Rank "
                   "0's program of the same case (the engine built on rank "
                   "0 of a dry mesh: its block of the cohort, the row "
                   "shard's all-reduce a dtype segment and all-gathers) "
                   "run once on meta. Rank 0 stands for every rank: each "
                   "issues the same calls, and where the cohort does not "
                   "divide 'data' the all-gather moves every rank's rows "
                   "padded to the longest block, so the bytes are equal "
                   "on every rank too. The port issues no reduce-scatter "
                   "and no collective-permute (0). Its barrier (after an "
                   "FL checkpoint; no bytes) is no XLA kind and is left "
                   "out. A one-device mesh issues none. The reference's "
                   "numbers are XLA's for its partitioned program, "
                   "another program: compare them, do not equate them.",
    "collectives_staged": "by the same kinds, the bytes gloo stages "
                          "through the host when the rank's tensors are "
                          "CUDA tensors (each tensor copied down, each "
                          "result copied back: "
                          "launch/collectives.staged_bytes): what ranks "
                          "sharing one card over gloo move through the "
                          "host; 0 over nccl.",
}


def _cnn_case(method: str, mesh_kind: str):
    from repro_torch.configs import vgg9
    grouped = methods_lib.get(method).uses_groups
    if mesh_kind == "host":     # reduced widths: the CPU smoke
        cfg = (vgg9.reduced(fed2_groups=5, decouple=3, norm="gn")
               if grouped else vgg9.reduced(fed2_groups=0, norm="none"))
    else:
        cfg = (vgg9.full(fed2_groups=10, decouple=6, norm="gn")
               if grouped else vgg9.baseline())
    return cnn_task(cfg), cfg.arch_id


def _lm_case(method: str):
    from repro_torch.configs import get_config
    from repro_torch.configs.common import with_fed2
    cfg = get_config("llama3.2-1b", reduced=True)
    if methods_lib.get(method).uses_groups:
        cfg = with_fed2(cfg, groups=4, decouple=1)
    return lm_task(cfg), "llama3.2-1b-reduced"


def _batch_elems(family: str, batch: int, seq: int) -> dict:
    if family == "cnn":
        return {"images": ((batch, 32, 32, 3), torch.float32),
                "labels": ((batch,), torch.int32)}
    return {"tokens": ((batch, seq), torch.int32),
            "labels": ((batch, seq), torch.int32),
            "mask": ((batch, seq), torch.float32)}


def _shapes(tree) -> list:
    return [(tuple(t.shape), t.dtype) for t in tree_leaves(tree)]


def meta_pass(step):
    """The program once on its meta arguments under FlopCounterMode and
    ``traced_reads``: (flops, seconds). Raises when its outputs or the
    reads of its meta arguments differ from what the build declared."""
    from torch.utils.flop_counter import FlopCounterMode
    t0 = time.time()
    with FlopCounterMode(display=False) as counter:
        out, reads = traced_reads(step.call, step.args)
    seconds = time.time() - t0
    if _shapes(out) != _shapes(step.outs):
        raise AssertionError(f"outputs {_shapes(out)} != the declared "
                             f"{_shapes(step.outs)}")
    for i, (arg, said, saw) in enumerate(zip(step.args, step.reads, reads)):
        on_meta = [t for t in tree_leaves(arg)
                   if isinstance(t, torch.Tensor) and t.is_meta]
        if on_meta and said != saw:
            raise AssertionError(f"argument {i}: declared read={said}, "
                                 f"the trace says {saw}")
    return counter.get_total_flops(), seconds


def memory(step, mesh) -> dict:
    """One device's bytes of the arguments the program reads and of its
    outputs (``NOTES["memory"]``)."""
    args = sum(shd.per_device_bytes(a, s, mesh)
               for a, s, r in zip(step.args, step.specs, step.reads)
               if r and s is not None)
    outs = sum(shd.per_device_bytes(o, s, mesh)
               for o, s in zip(step.outs, step.out_specs, strict=True))
    table = 8 * step.out_leaves if step.out_leaves > 1 else 0
    return {"temp_bytes": None, "argument_bytes": args,
            "output_bytes": outs + table, "output_table_bytes": table}


def rank_counts(step) -> Counts:
    """The collectives rank 0 issues in ``step``: its ``rank`` program
    run once on meta (none on one device)."""
    return Counts() if step.rank is None else step.rank.counts()


class Skipped(Exception):
    """A case the matrix lists but the method cannot run (the reason)."""


def _run_case(rec: dict, mesh, outdir: str, build, *, meta: bool,
              verbose: bool) -> dict:
    """``build()`` -> (LoweredStep, head, tail): the step, then the
    case's own record keys before and after the common ones (or it
    raises ``Skipped``: a ``skipped`` record with the reason). Records
    the build's seconds, the meta pass (when ``meta``) and the bytes; an
    exception becomes an ``error`` record. Writes the record as
    ``dryrun_<tag>.json``."""
    tag = _tag(rec)
    try:
        t0 = time.time()
        try:
            step, head, tail = build()
        except Skipped as why:
            rec.update(status="skipped", reason=str(why))
            _write(outdir, tag, rec)
            if verbose:
                print(f"[skip] {tag}: {why}")
            return rec
        t_lower = time.time() - t0
        flops, t_pass = meta_pass(step) if meta else (None, 0.0)
        coll, staged = collectives(rank_counts(step))
        rec.update(status="ok", **head, lower_s=round(t_lower, 2),
                   compile_s=round(t_pass, 2) if meta else None,
                   flops=None if flops is None else float(flops),
                   use_kernel=step.use_kernel, memory=memory(step, mesh),
                   collectives=coll, collectives_staged=staged,
                   route=ROUTE, notes=NOTES, **tail)
        _stamp_wall(rec, t_lower, t_pass)
        if verbose:
            mem = rec["memory"]
            moved = ", ".join(f"{k} {v['count']} x {v['bytes']:,} B"
                              for k, v in coll.items() if v["count"])
            print(f"[ok]   {tag}: build {t_lower:.1f}s meta pass "
                  f"{t_pass:.1f}s flops {rec['flops']} args "
                  f"{mem['argument_bytes']:,} B outputs "
                  f"{mem['output_bytes']:,} B per device; collectives "
                  f"a rank: {moved or 'none'}")
    except Exception as e:  # noqa: BLE001 — record, keep the matrix going
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[FAIL] {tag}: {type(e).__name__}: {e}")
    _write(outdir, tag, rec)
    return rec


def _stamp_wall(rec, t_lower, t_compile):
    """Measured build + meta-pass wall and the reference's budget for
    it (4x, at least 10 s)."""
    wall = t_lower + t_compile
    rec["wall_s"] = round(wall, 2)
    rec["max_wall_s"] = max(10.0, float(math.ceil(4 * wall)))


def _tag(rec) -> str:
    """The record's file tag (``dryrun_<tag>.json``)."""
    kind, m, mesh = rec["kind"], rec["method"], rec["mesh"]
    if kind == "fl_round":
        return f"fl_round_{m}_{rec['family']}_{mesh}"
    if kind == "fl_tier":
        return f"fl_tier_{m}_w{round(rec['width'] * 100):03d}_{mesh}"
    if kind == "fl_async":
        return f"fl_async_{m}_{rec['family']}_{mesh}"
    if kind in ("fl_robust", "fl_fast"):
        spec = rec["robust" if kind == "fl_robust" else "codec"]
        return f"{kind}_{m}_{spec.split('(', 1)[0].strip()}_{mesh}"
    return f"fl_align_{rec['alignment']}_{mesh}"


def _write(outdir, tag, rec):
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, f"dryrun_{tag}.json"), "w") as f:
        json.dump(rec, f, indent=1)


def _kind(mesh_name: str) -> str:
    return "host" if mesh_name == "1x1" else "pod"


def run_one(method: str, family: str, mesh, mesh_name: str, *,
            clients: int, local_steps: int, batch: int, seq: int,
            outdir: str, cohort_size=None, sampler: str = "full",
            use_kernel=None, verbose: bool = True,
            meta: bool = True) -> dict:
    """One round of ``method`` on ``family``'s case. ``meta=False``
    records the build and the bytes without the meta pass (flops and
    compile_s null)."""
    rec = {"kind": "fl_round", "method": method, "family": family,
           "mesh": mesh_name, "population": clients,
           "cohort_size": clients if cohort_size is None else cohort_size,
           "participation": sampler,
           "local_steps": local_steps, "batch": batch}
    meth = methods_lib.get(method)

    def build():
        task, arch = (_cnn_case(method, _kind(mesh_name))
                      if family == "cnn" else _lm_case(method))
        if meth.host_fusion and task.matched_average_fn is None:
            raise Skipped(f"{method} needs task.matched_average_fn (host "
                          "matched averaging is defined for non-grouped "
                          "CNNs; no LM analog)")
        fl = FLConfig(population=clients, cohort_size=cohort_size,
                      sampler=sampler, method=method)
        step = lower_round(task, fl, mesh,
                           _batch_elems(family, batch, seq),
                           local_steps=local_steps, use_kernel=use_kernel)
        return step, {"arch": arch}, {
            "host_matching": meth.host_fusion,
            # the lowered round's gather: one cohort of stacked params
            "host_gather_bytes": (stacked_param_bytes(
                task, rec["cohort_size"]) if meth.host_fusion else 0)}

    return _run_case(rec, mesh, outdir, build, meta=meta, verbose=verbose)


# widths per tier-matrix method: group-structured methods keep WHOLE
# feature groups (width*G integer at both the reduced G=5 and full G=10
# nets), coordinate methods slice any prefix width
TIER_WIDTHS_GROUPED = (1.0, 0.6, 0.2)
TIER_WIDTHS_PLAIN = (1.0, 0.5, 0.25)


def run_tier_one(method: str, width: float, mesh, mesh_name: str, *,
                 clients: int, local_steps: int, batch: int, outdir: str,
                 use_kernel=None, verbose: bool = True,
                 meta: bool = True) -> dict:
    """One capacity tier's tile (fl/capacity.py): the local phase and
    the within-tier fuse at the tier's sub-model shapes, with the tier's
    per-client uplink bytes."""
    from repro_torch.fl.capacity import lower_tier_tile

    rec = {"kind": "fl_tier", "method": method, "family": "cnn",
           "mesh": mesh_name, "width": width, "cohort_size": clients,
           "local_steps": local_steps, "batch": batch}

    def build():
        task, arch = _cnn_case(method, _kind(mesh_name))
        fl = FLConfig(population=clients, method=method)
        step, model = lower_tier_tile(task, fl, mesh,
                                      _batch_elems("cnn", batch, 0),
                                      width=width, local_steps=local_steps,
                                      use_kernel=use_kernel)
        full_bytes = stacked_param_bytes(task, 1)
        return step, {"arch": arch, "tier_arch": model.model_cfg.arch_id,
                      "kept_groups": model.model_cfg.fed2_groups}, {
            "params_bytes": model.param_bytes,
            "full_params_bytes": full_bytes,
            "uplink_frac": round(model.param_bytes / full_bytes, 4)}

    return _run_case(rec, mesh, outdir, build, meta=meta, verbose=verbose)


def run_tier_matrix(mesh, mesh_name: str, *, methods=("fedavg", "fed2"),
                    clients: int, local_steps: int, batch: int,
                    outdir: str, use_kernel=None, verbose: bool = True,
                    meta: bool = True) -> list:
    recs = []
    for m in methods:
        grouped = methods_lib.get(m).uses_groups
        for w in TIER_WIDTHS_GROUPED if grouped else TIER_WIDTHS_PLAIN:
            recs.append(run_tier_one(m, w, mesh, mesh_name, clients=clients,
                                     local_steps=local_steps, batch=batch,
                                     outdir=outdir, use_kernel=use_kernel,
                                     verbose=verbose, meta=meta))
    return recs


def run_async_one(method: str, family: str, mesh, mesh_name: str, *,
                  clients: int, buffer_k: int, local_steps: int,
                  batch: int, seq: int, outdir: str, use_kernel=None,
                  verbose: bool = True, meta: bool = True) -> dict:
    """One buffered-async fusion event (fl/async_engine.py): the
    staleness-weighted fuse and the server step over ``buffer_k`` rows,
    the async mode's only program of its own (its local tiles are the
    sync engine's)."""
    from repro_torch.fl.async_engine import lower_async_event

    rec = {"kind": "fl_async", "method": method, "family": family,
           "mesh": mesh_name, "population": clients,
           "cohort_size": clients, "buffer_k": buffer_k,
           "local_steps": local_steps, "batch": batch}

    def build():
        task, arch = (_cnn_case(method, _kind(mesh_name))
                      if family == "cnn" else _lm_case(method))
        fl = FLConfig(population=clients, method=method, mode="async",
                      buffer_k=buffer_k)
        return (lower_async_event(task, fl, mesh, use_kernel=use_kernel),
                {"arch": arch}, {})

    return _run_case(rec, mesh, outdir, build, meta=meta, verbose=verbose)


def run_async_matrix(mesh, mesh_name: str, *, methods=("fedavg", "fed2"),
                     families=FAMILIES, clients: int, local_steps: int,
                     batch: int, seq: int, outdir: str, use_kernel=None,
                     verbose: bool = True, meta: bool = True) -> list:
    """The events of the async-eligible ``methods`` at buffer_k =
    cohort/2, the sub-cohort buffering the mode exists for."""
    eligible = [m for m in methods
                if compat_lib.supports(methods_lib.get(m), "async")]
    buffer_k = max(1, clients // 2)
    return [run_async_one(m, f, mesh, mesh_name, clients=clients,
                          buffer_k=buffer_k, local_steps=local_steps,
                          batch=batch, seq=seq, outdir=outdir,
                          use_kernel=use_kernel, verbose=verbose,
                          meta=meta)
            for f in families for m in eligible]


# adversarial rounds (fl/attacks.py + fl/robust.py): one REDUCING robust
# rule per fusion family, each with sign_flip poisoning on 20 % of the
# clients
ROBUST_MATRIX = (("fedavg", "coordinate_median"),
                 ("fed2", "trimmed_mean(0.2)"))


def run_robust_one(method: str, rule: str, mesh, mesh_name: str, *,
                   clients: int, local_steps: int, batch: int,
                   outdir: str, verbose: bool = True,
                   meta: bool = True) -> dict:
    """One adversarial round: the local phase with sign_flip poisoning
    of the first cohort's attackers, fused by a reducing robust rule (a
    sort per coordinate, no kernel)."""
    rec = {"kind": "fl_robust", "method": method, "family": "cnn",
           "mesh": mesh_name, "population": clients,
           "cohort_size": clients, "local_steps": local_steps,
           "batch": batch, "attack": "sign_flip(4)", "robust": rule}

    def build():
        task, arch = _cnn_case(method, _kind(mesh_name))
        fl = FLConfig(population=clients, method=method,
                      attack="sign_flip(4)", attack_fraction=0.2,
                      robust=rule)
        return (lower_round(task, fl, mesh, _batch_elems("cnn", batch, 0),
                            local_steps=local_steps), {"arch": arch}, {})

    return _run_case(rec, mesh, outdir, build, meta=meta, verbose=verbose)


def run_robust_matrix(mesh, mesh_name: str, *, methods=("fedavg", "fed2"),
                      clients: int, local_steps: int, batch: int,
                      outdir: str, verbose: bool = True,
                      meta: bool = True) -> list:
    return [run_robust_one(m, rule, mesh, mesh_name, clients=clients,
                           local_steps=local_steps, batch=batch,
                           outdir=outdir, verbose=verbose, meta=meta)
            for m, rule in ROBUST_MATRIX if m in methods]


# fast-path rounds: one bf16 local phase + compressed uplink per fusion
# family, with the codec's per-client uplink bytes beside the dense
FAST_MATRIX = (("fedavg", "int8"), ("fed2", "topk(0.05)"))


def run_fast_one(method: str, codec_spec: str, mesh, mesh_name: str, *,
                 clients: int, local_steps: int, batch: int,
                 outdir: str, use_kernel=None, verbose: bool = True,
                 meta: bool = True) -> dict:
    """One fast-path round: the bf16 local phase (fp32 fusion) with the
    uplink codec's decode-then-fuse round trip; ``uplink_bytes`` per
    client against the dense ``full_params_bytes``."""
    from repro_torch.fl import codec as codec_lib

    rec = {"kind": "fl_fast", "method": method, "family": "cnn",
           "mesh": mesh_name, "population": clients,
           "cohort_size": clients, "local_steps": local_steps,
           "batch": batch, "compute_dtype": "bfloat16",
           "codec": codec_spec}

    def build():
        task, arch = _cnn_case(method, _kind(mesh_name))
        fl = FLConfig(population=clients, method=method,
                      compute_dtype="bfloat16", codec=codec_spec)
        step = lower_round(task, fl, mesh, _batch_elems("cnn", batch, 0),
                           local_steps=local_steps, use_kernel=use_kernel)
        dense = stacked_param_bytes(task, 1)
        up = codec_lib.parse_codec(codec_spec).bytes_per_client(
            param_shapes(task))
        return step, {"arch": arch}, {
            "params_bytes": up, "full_params_bytes": dense,
            "uplink_bytes": up, "uplink_frac": round(up / dense, 4)}

    return _run_case(rec, mesh, outdir, build, meta=meta, verbose=verbose)


def run_fast_matrix(mesh, mesh_name: str, *, methods=("fedavg", "fed2"),
                    clients: int, local_steps: int, batch: int,
                    outdir: str, use_kernel=None, verbose: bool = True,
                    meta: bool = True) -> list:
    return [run_fast_one(m, spec, mesh, mesh_name, clients=clients,
                         local_steps=local_steps, batch=batch,
                         outdir=outdir, use_kernel=use_kernel,
                         verbose=verbose, meta=meta)
            for m, spec in FAST_MATRIX if m in methods]


# alignment rounds (fl/alignment.py): one PAN round, a plain net fused
# by fedavg with fixed position encodings in every hidden layer
ALIGN_MATRIX = (("fedavg", "pan"),)


def run_align_one(method: str, strategy: str, mesh, mesh_name: str, *,
                  clients: int, local_steps: int, batch: int,
                  outdir: str, use_kernel=None, verbose: bool = True,
                  meta: bool = True) -> dict:
    """One aligned round: the strategy's model config (a plain net + PAN
    encodings for 'pan') through the same round engine."""
    from repro_torch.configs import vgg9
    from repro_torch.fl import alignment as alignment_lib

    rec = {"kind": "fl_align", "method": method, "family": "cnn",
           "mesh": mesh_name, "population": clients,
           "cohort_size": clients, "local_steps": local_steps,
           "batch": batch, "alignment": strategy}

    def build():
        strat = alignment_lib.get(strategy)
        meth = methods_lib.get(method)
        if _kind(mesh_name) == "host":
            cfg = alignment_lib.build_model_config(
                strat, meth,
                grouped_fn=lambda: vgg9.reduced(fed2_groups=5, decouple=3,
                                                norm="gn"),
                plain_fn=lambda: vgg9.reduced(fed2_groups=0, norm="none"))
        else:
            cfg = alignment_lib.build_model_config(
                strat, meth,
                grouped_fn=lambda: vgg9.full(fed2_groups=10, decouple=6,
                                             norm="gn"),
                plain_fn=vgg9.baseline)
        fl = FLConfig(population=clients, method=method,
                      alignment=strategy)
        step = lower_round(cnn_task(cfg), fl, mesh,
                           _batch_elems("cnn", batch, 0),
                           local_steps=local_steps, use_kernel=use_kernel)
        return step, {"arch": cfg.arch_id, "pan_scale": cfg.pan}, {}

    return _run_case(rec, mesh, outdir, build, meta=meta, verbose=verbose)


def run_align_matrix(mesh, mesh_name: str, *, methods=("fedavg",),
                     clients: int, local_steps: int, batch: int,
                     outdir: str, use_kernel=None, verbose: bool = True,
                     meta: bool = True) -> list:
    return [run_align_one(m, strat, mesh, mesh_name, clients=clients,
                          local_steps=local_steps, batch=batch,
                          outdir=outdir, use_kernel=use_kernel,
                          verbose=verbose, meta=meta)
            for m, strat in ALIGN_MATRIX if m in methods]


def run_matrix(*, mesh_kind: str = "pod", methods=None,
               families=FAMILIES, clients: int = 16, local_steps: int = 4,
               batch: int = 32, seq: int = 64, outdir: str = DEFAULT_OUT,
               cohort_size=None, sampler: str = "full",
               use_kernel=None, tiers: bool = True,
               async_events: bool = True, robust_events: bool = True,
               fast_events: bool = True, align_events: bool = True,
               verbose: bool = True, meta: bool = True) -> list:
    methods = methods_lib.available() if methods is None else methods
    bad = [m for m in methods if m not in methods_lib.available()] + \
          [f for f in families if f not in FAMILIES]
    if bad:
        raise ValueError(f"unknown method/family: {bad}; "
                         f"methods={methods_lib.available()} "
                         f"families={FAMILIES}")
    if mesh_kind == "host":
        mesh, mesh_name = make_host_mesh(), "1x1"
    elif mesh_kind == "pod":
        mesh, mesh_name = make_production_mesh(), "16x16"
    else:
        raise ValueError(f"unknown mesh_kind: {mesh_kind!r} "
                         "(expected 'pod' or 'host')")
    common = dict(clients=clients, local_steps=local_steps, batch=batch,
                  outdir=outdir, verbose=verbose, meta=meta)
    pair = [m for m in ("fedavg", "fed2") if m in methods]
    recs = [run_one(m, f, mesh, mesh_name, seq=seq, cohort_size=cohort_size,
                    sampler=sampler, use_kernel=use_kernel, **common)
            for f in families for m in methods]
    if tiers and "cnn" in families:
        recs += run_tier_matrix(mesh, mesh_name, methods=pair,
                                use_kernel=use_kernel, **common)
    if async_events:
        recs += run_async_matrix(mesh, mesh_name, methods=pair,
                                 families=families, seq=seq,
                                 use_kernel=use_kernel, **common)
    if robust_events and "cnn" in families:
        recs += run_robust_matrix(mesh, mesh_name, methods=pair, **common)
    if fast_events and "cnn" in families:
        recs += run_fast_matrix(mesh, mesh_name, methods=pair,
                                use_kernel=use_kernel, **common)
    if align_events and "cnn" in families:
        recs += run_align_matrix(mesh, mesh_name,
                                 methods=[m for m in ("fedavg",)
                                          if m in methods],
                                 use_kernel=use_kernel, **common)
    return recs


def compare(recs: list, ref_dir: str) -> list:
    """Each ``ok`` record beside the reference's record of its tag in
    ``ref_dir`` (the committed ``benchmarks/artifacts_perf``): whether
    the per-device argument and output bytes are equal, torch's FLOPs
    over XLA's, and each collective kind's count and bytes, the port's
    rank program's beside XLA's (two programs: shown, not held equal).
    Lines to print."""
    lines = []
    for rec in recs:
        if rec["status"] != "ok":
            continue
        tag = _tag(rec)
        path = os.path.join(ref_dir, f"dryrun_{tag}.json")
        if not os.path.exists(path):
            lines.append(f"[vs]   {tag}: no reference record")
            continue
        with open(path) as f:
            ref = json.load(f)
        same = {k: rec["memory"][k] == ref["memory"][k]
                for k in ("argument_bytes", "output_bytes")}
        ratio = ("n/a" if not rec["flops"] or not ref.get("flops")
                 else f"{rec['flops'] / ref['flops']:.3f}")
        lines.append(f"[vs]   {tag}: bytes equal {same}; flops torch "
                     f"{rec['flops']} / XLA {ref.get('flops')} = {ratio}")
        theirs = ref.get("collectives") or {}
        kinds = []
        for xla, _ in XLA_KINDS:
            a = rec["collectives"][xla]
            b = theirs.get(xla, {"count": 0, "bytes": 0})
            kinds.append(f"{xla} {a['count']} x {a['bytes']:,} B / "
                         f"{b['count']} x {b['bytes']:,} B")
        lines.append(f"[vs]   {tag}: collectives port / XLA (calls x "
                     f"result bytes): {'; '.join(kinds)}")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod", choices=["pod", "host"])
    ap.add_argument("--methods", default="all",
                    help="comma list from "
                         f"{','.join(methods_lib.available())} or 'all'")
    ap.add_argument("--families", default="all",
                    help="comma list of cnn,lm or 'all'")
    ap.add_argument("--clients", type=int, default=16,
                    help="logical client population")
    ap.add_argument("--cohort-size", type=int, default=None,
                    help="engine width (the round's client-axis width); "
                         "default = --clients")
    ap.add_argument("--sampler", default="full",
                    choices=list(population_lib.available()),
                    help="participation strategy recorded in the JSON")
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--use-kernel", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="record the paired_fusion route on "
                         "(--use-kernel) or off (--no-use-kernel); "
                         "default on. A mesh of more than one device "
                         "records it off; the meta pass always takes the "
                         "plain route")
    ap.add_argument("--tiers", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="also build the capacity-tier tiles (fedavg+fed2 "
                         "x sub-model widths, cnn; fl/capacity.py)")
    ap.add_argument("--async-events",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="also build the buffered-async fusion events "
                         "(async-eligible fedavg+fed2 x families; "
                         "fl/async_engine.py)")
    ap.add_argument("--robust-events",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="also build the adversarial robust-fusion rounds "
                         "(sign_flip poisoning + fedavg x "
                         "coordinate_median / fed2 x trimmed_mean, cnn)")
    ap.add_argument("--fast-events",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="also build the fast-path rounds (bf16 local "
                         "phase + uplink codec: fedavg x int8 / fed2 x "
                         "topk, cnn)")
    ap.add_argument("--align-events",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="also build the alignment round (fedavg x PAN "
                         "position encodings, cnn)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--against", default=None,
                    help="a directory of the reference's records (e.g. "
                         "benchmarks/artifacts_perf): print each record's "
                         "bytes beside them, torch's FLOPs over XLA's and "
                         "each collective kind, the port's beside XLA's")
    args = ap.parse_args(argv)

    methods = methods_lib.available() if args.methods == "all" \
        else tuple(args.methods.split(","))
    families = FAMILIES if args.families == "all" \
        else tuple(args.families.split(","))
    recs = run_matrix(mesh_kind=args.mesh, methods=methods,
                      families=families, clients=args.clients,
                      local_steps=args.local_steps, batch=args.batch,
                      seq=args.seq, outdir=args.out,
                      cohort_size=args.cohort_size, sampler=args.sampler,
                      use_kernel=args.use_kernel, tiers=args.tiers,
                      async_events=args.async_events,
                      robust_events=args.robust_events,
                      fast_events=args.fast_events,
                      align_events=args.align_events)
    if args.against:
        print("\n".join(compare(recs, args.against)))
    n_fail = sum(r["status"] == "error" for r in recs)
    print(f"done; {len(recs)} records, {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
