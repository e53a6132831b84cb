"""Dry-run of every (arch x input shape x mesh): does the step build at
full size, and what must each device hold? The port's record of the
reference's ``repro.launch.dryrun``. No memory is ever allocated: every
tensor lives on ``meta``.

The reference lowers and compiles each step with XLA on 512 fake
devices. The port answers the same questions without devices:

- **builds** (``lower_s``): the config, the parameters, the AdamW state
  (fp32 m and v, as ``launch/steps.make_train_step``), the batch, or
  the decode cache with its token and position, all on ``meta``, with
  the reference's placement decisions (``build_lowered``);
- **runs** (``compile_s``): the step once on those meta tensors under
  ``torch.utils.flop_counter.FlopCounterMode``. It takes the plain
  routes, asked for explicitly (``use_kernel=False``): no kernel
  accepts a meta tensor;
- **fits**: each device's bytes of the step's arguments and outputs
  under ``launch/sharding.py``'s rules, exactly (they are a function of
  the rules and the shapes alone);
- **moves** (``collectives``, the prefill and decode records of
  ``COVERED_ARCHS``): rank 0's program of the sharded step
  (``models/parallel.py``) on its shares, on a dry mesh
  (``launch/mesh.make_dry_rank_mesh``: no process group, the
  collectives only count), run once on ``meta``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape train_4k --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # full matrix

Records land in ``runs_torch/dryrun/dryrun_<arch>_<shape>_<mesh>.json``
(``--out``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Callable

import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.configs.common import with_fed2
from repro_torch.configs.shapes import INPUT_SHAPES, InputShape
from repro_torch.launch import sharding as shd
from repro_torch.launch.analytic import analytic_cost
from repro_torch.launch.collectives import by_xla_kind
from repro_torch.launch.mesh import (Mesh, batch_axes, make_dry_rank_mesh,
                                     make_production_mesh, mesh_chips)
from repro_torch.launch.steps import (make_prefill_loss_step,
                                      make_serve_step, make_train_step)
from repro_torch.models.forward import init_cache
from repro_torch.models.module import tree_leaves
from repro_torch.models.transformer import init_params

OUT_DIR = "runs_torch/dryrun"

# the archs whose prefill and decode records carry the rank program's
# collectives
COVERED_ARCHS = ("llama3.2-1b", "mamba2-1.3b")
# what the torch record holds where the reference's holds XLA's numbers
NOTES = {
    "flops": "torch.utils.flop_counter.FlopCounterMode's count of the "
             "whole global step on the plain route (matmuls, "
             "convolutions and attention products; elementwise ops "
             "count 0). The reference's 'flops' is XLA's per-device "
             "cost_analysis(), which counts a scanned layer once.",
    "memory": "argument_bytes and output_bytes: one device's share under "
              "launch/sharding.py's rules, exact (a ceiling where a split "
              "is uneven); outputs placed as the inputs they replace, "
              "logits by batch only (XLA chooses its own output "
              "placement). temp_bytes and code_bytes: null, XLA's buffer "
              "assignment and code have no meta counterpart.",
    "collectives": "what one rank issues in the port's sharded prefill "
                   "or decode program (models/parallel.py over "
                   "launch/collectives.py), by XLA's kinds: bytes = its "
                   "result buffers' bytes summed, count = its calls. Rank "
                   "0's program on its shares (launch/sharding.cut) on a "
                   "dry mesh, run once on meta (rank_program_s: its "
                   "seconds); the (2, 16, 16) mesh's batch axes fold into "
                   "one batch line of 32 ('data'), so the loss's sums "
                   "take one all-reduce over it. Every rank issues the "
                   "same calls of the same sizes (every split is even). "
                   "Row-parallel partials travel in the activations' "
                   "dtype (bf16), attention's partial decode scores in "
                   "fp32. Carried by the prefill_32k, decode_32k and "
                   "long_500k records of " + " and ".join(COVERED_ARCHS)
                   + " (± fed2); null "
                   "elsewhere: the port's sharded program covers the "
                   "dense and ssm families' prefill and decode (and runs "
                   "only these two archs' records), and has no train "
                   "step (tensor-parallel backward, ZeRO-1, gradient "
                   "sync), no moe, hybrid, encdec or vlm program. XLA's "
                   "numbers for the reference are another program's.",
    "collectives_staged": "by the same kinds, the bytes gloo stages "
                          "through the host when the rank's tensors are "
                          "CUDA tensors (launch/collectives.staged_bytes); "
                          "0 over nccl.",
}


def applicable(arch: str, shape_name: str, *,
               swa_override: bool = False) -> tuple[bool, str]:
    cfg = get_config(arch)
    if shape_name == "long_500k" and not cfg.is_subquadratic \
            and not swa_override:
        return False, ("pure full-attention decoder: 524k dense KV cache "
                       "has no sub-quadratic variant in the source config "
                       "(DESIGN.md §Shape-applicability); rerun with "
                       "--swa-override for the beyond-paper SWA variant")
    return True, ""


def mesh_name(mesh: Mesh) -> str:
    return "x".join(str(s) for s in mesh.sizes)


@dataclasses.dataclass
class MetaStep:
    """A step and its arguments on ``meta``, each argument beside its
    placement: what the reference hands ``jax.jit(step).lower``."""
    call: Callable         # call(*args) -> the step's outputs
    args: tuple            # trees of meta tensors
    specs: tuple           # the args' spec trees
    out_specs: tuple       # the outputs' spec trees


def config_of(arch: str, *, fed2: bool = False, swa_override: bool = False):
    """The bf16 full config the dry-run builds (the reference's)."""
    cfg = get_config(arch, dtype=torch.bfloat16)
    if swa_override and cfg.window is None and cfg.family in ("dense",
                                                              "vlm"):
        # beyond-paper opt-in: sliding-window variant for long-context
        cfg = dataclasses.replace(cfg, window=4096)
    return with_fed2(cfg) if fed2 else cfg


def train_microbatches(cfg, n_par: int) -> int:
    """The reference's rule: by total parameters ``n_par``, at least 8
    for the SSD families (their (B, H, Q, Q) chunk tiles dominate);
    ``REPRO_MICROBATCHES`` overrides it."""
    microbatches = (16 if n_par > 100e9 else 8 if n_par > 10e9 else
                    4 if n_par > 4e9 else 2)
    if cfg.family in ("ssm", "hybrid"):
        microbatches = max(microbatches, 8)
    if os.environ.get("REPRO_MICROBATCHES"):
        microbatches = int(os.environ["REPRO_MICROBATCHES"])
    return microbatches


def serve_fsdp(n_par: int, mesh: Mesh) -> bool:
    """ZeRO-placed weights for prefill and decode when one model group's
    bf16 share of ``n_par`` parameters exceeds 12 GiB (mixtral 282 GB,
    deepseek 472 GB over 16 devices), or under ``REPRO_SERVE_FSDP``.
    12 GiB is the reference's threshold for a 16 GiB TPU v5e, kept so
    that the records describe the reference's program and its bytes
    match."""
    per_group_gb = n_par * 2 / mesh.shape["model"] / 2**30
    return per_group_gb > 12.0 or bool(os.environ.get("REPRO_SERVE_FSDP"))


def build_lowered(arch: str, shape_name: str, *, mesh: Mesh,
                  fed2: bool = False, swa_override: bool = False):
    """The step of (arch, shape) and its placed meta arguments on
    ``mesh``: (MetaStep, cfg)."""
    cfg = config_of(arch, fed2=fed2, swa_override=swa_override)
    return build_step(cfg, INPUT_SHAPES[shape_name], mesh), cfg


def build_step(cfg, shape: InputShape, mesh: Mesh) -> MetaStep:
    """``build_lowered`` for any config and shape (the tests' reduced
    ones)."""
    params = init_params(torch.Generator(), cfg, device="meta")
    n_par = sum(math.prod(t.shape) for t in tree_leaves(params))
    pspecs = shd.param_shardings(params, cfg, mesh)

    if shape.mode == "train":
        step_fn, opt = make_train_step(
            cfg, microbatches=train_microbatches(cfg, n_par))
        ostate = opt.init(params)
        zspecs = shd.zero1_shardings(params, cfg, mesh)
        ospecs = {"m": zspecs, "v": zspecs}
        step = torch.empty((), dtype=torch.int32, device="meta")
        batch, bspecs = shd.batch_specs(cfg, shape, mesh)
        return MetaStep(
            lambda p, o, _s, b: step_fn(p, o, 0, b),
            (params, ostate, step, batch), (pspecs, ospecs, (), bspecs),
            (pspecs, ospecs, ()))
    if serve_fsdp(n_par, mesh):
        pspecs = shd.zero1_shardings(params, cfg, mesh)
    if shape.mode == "prefill":
        step_fn = make_prefill_loss_step(cfg, use_kernel=False)
        batch, bspecs = shd.batch_specs(cfg, shape, mesh)
        return MetaStep(step_fn, (params, batch), (pspecs, bspecs), ((),))
    step_fn = make_serve_step(cfg, use_kernel=False)
    cache, cspecs = shd.cache_specs(cfg, shape, mesh)
    (tok, pos), (tspec, posspec) = shd.decode_token_specs(cfg, shape, mesh)
    # the position is a host int in the port; the record counts it as
    # the reference's int32 scalar. The last slot of the context:
    last = shape.seq_len - 1
    return MetaStep(
        lambda p, c, t, _pos: step_fn(p, c, t, last),
        (params, cache, tok, pos), (pspecs, cspecs, tspec, posspec),
        ((tspec[0], None, None), cspecs))


def covered(arch: str, cfg, shape: InputShape, mesh: Mesh) -> bool:
    """Whether the record of (arch, shape) on ``mesh`` carries the rank
    program's collectives (``NOTES["collectives"]``)."""
    return (arch in COVERED_ARCHS and shape.mode != "train"
            and not serve_fsdp(sum(math.prod(t.shape) for t in tree_leaves(
                init_params(torch.Generator(), cfg, device="meta"))), mesh))


def dry_rank_mesh(mesh: Mesh):
    """Rank 0 of ``mesh`` with no process group, on ``meta``: its batch
    axes folded into one "data" line (pod x data)."""
    nb = math.prod(mesh.shape[a] for a in batch_axes(mesh))
    return make_dry_rank_mesh((nb, mesh.shape["model"]), 0, device="meta")


def rank_program(cfg, shape: InputShape, mesh: Mesh):
    """Rank 0's program of the sharded prefill loss or decode step of
    (cfg, shape) on ``mesh``, run once on its meta shares: (the dry
    mesh, whose ``counts`` hold what it issued, the step's output)."""
    rmesh = dry_rank_mesh(mesh)
    params = init_params(torch.Generator(), cfg, device="meta")
    params = shd.cut(params, shd.param_shardings(params, cfg, rmesh), rmesh)
    lo, hi = shd.batch_rows(rmesh, shape.global_batch)
    if shape.mode == "prefill":
        batch, _ = shd.batch_specs(cfg, shape, rmesh)
        out = make_prefill_loss_step(cfg, use_kernel=False, mesh=rmesh)(
            params, {k: v[lo:hi] for k, v in batch.items()})
        return rmesh, out
    cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                       device="meta", mesh=rmesh)
    tok = torch.empty((hi - lo, 1), dtype=torch.int32, device="meta")
    out = make_serve_step(cfg, use_kernel=False, mesh=rmesh)(
        params, cache, tok, shape.seq_len - 1)
    return rmesh, out


def meta_pass(step: MetaStep):
    """The step once on its meta arguments under FlopCounterMode:
    (flops, outputs, seconds)."""
    from torch.utils.flop_counter import FlopCounterMode
    t0 = time.time()
    with FlopCounterMode(display=False) as counter:
        out = step.call(*step.args)
    return counter.get_total_flops(), out, time.time() - t0


def argument_bytes(step: MetaStep, mesh: Mesh) -> int:
    return sum(shd.per_device_bytes(a, s, mesh)
               for a, s in zip(step.args, step.specs))


def record(step: MetaStep, cfg, shape: InputShape, mesh: Mesh,
           lower_s: float, meta: tuple) -> dict:
    """The fields of an ``ok`` record: ``meta`` is ``meta_pass(step)``'s
    (flops, outputs, seconds)."""
    flops, out, t_pass = meta
    out = out if isinstance(out, tuple) else (out,)
    out_bytes = sum(shd.per_device_bytes(o, s, mesh)
                    for o, s in zip(out, step.out_specs, strict=True))
    return dict(
        status="ok",
        chips=mesh_chips(mesh),
        lower_s=round(lower_s, 2),
        compile_s=round(t_pass, 2),
        flops=float(flops),
        hlo_bytes=None,
        memory={"argument_bytes": argument_bytes(step, mesh),
                "output_bytes": out_bytes,
                "temp_bytes": None, "code_bytes": None},
        collectives=None,
        route="plain (use_kernel=False): no kernel takes a meta tensor",
        notes=NOTES,
        analytic=analytic_cost(cfg, shape),
    )


def run_one(arch: str, shape_name: str, *, mesh: Mesh, fed2: bool,
            outdir: str, verbose: bool = True, swa_override: bool = False,
            passes: dict | None = None) -> dict:
    """Build, run and record one cell. ``passes`` (a dict the caller
    keeps) holds each meta pass by (arch, shape, fed2, swa): the global
    step is the same on every mesh, so a second mesh reuses the first's
    pass and its record names the record that ran it
    (``meta_pass_of``)."""
    name = mesh_name(mesh)
    tag = f"{arch}_{shape_name}_{name}" + ("_fed2" if fed2 else "") \
        + ("_swa" if swa_override else "")
    ok, why = applicable(arch, shape_name, swa_override=swa_override)
    rec = {"arch": arch, "shape": shape_name, "mesh": name,
           "fed2": fed2, "swa_override": swa_override}
    if not ok:
        rec.update(status="skipped", reason=why)
        _write(outdir, tag, rec)
        if verbose:
            print(f"[skip] {tag}: {why}")
        return rec
    passes = {} if passes is None else passes
    try:
        t0 = time.time()
        step, cfg = build_lowered(arch, shape_name, mesh=mesh, fed2=fed2,
                                  swa_override=swa_override)
        t_lower = time.time() - t0
        key = (arch, shape_name, fed2, swa_override)
        if key not in passes:
            passes[key] = (meta_pass(step), tag)
        meta, pass_tag = passes[key]
        shape = INPUT_SHAPES[shape_name]
        rec.update(record(step, cfg, shape, mesh, t_lower, meta))
        if pass_tag != tag:
            rec["meta_pass_of"] = pass_tag
        if covered(arch, cfg, shape, mesh):
            t0 = time.time()
            rmesh, _ = rank_program(cfg, shape, mesh)
            rec["collectives"], rec["collectives_staged"] = by_xla_kind(
                rmesh.counts)
            rec["rank_program_s"] = round(time.time() - t0, 2)
        if verbose:
            ab = rec["memory"]["argument_bytes"]
            print(f"[ok]   {tag}: build {t_lower:.1f}s meta pass "
                  f"{meta[2]:.1f}s flops {meta[0]:.3e} "
                  f"args {ab / 2**30:.2f}GiB/device")
    except Exception as e:  # noqa: BLE001 — record the failure, keep matrix
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[FAIL] {tag}: {type(e).__name__}: {e}")
    _write(outdir, tag, rec)
    return rec


def _write(outdir, tag, rec):
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, f"dryrun_{tag}.json"), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="arch id or 'all'")
    ap.add_argument("--shape", default="all",
                    help="input shape name or 'all'")
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--fed2", action="store_true",
                    help="apply Fed2 structure adaptation")
    ap.add_argument("--swa-override", action="store_true",
                    help="beyond-paper: sliding-window attention for dense "
                         "archs (enables long_500k)")
    ap.add_argument("--all", action="store_true",
                    help="full matrix: all archs x shapes x both meshes")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    archs = list(ASSIGNED_ARCHS) if (args.all or args.arch == "all") \
        else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape == "all") \
        else [args.shape]
    meshes = [False, True] if (args.all or args.mesh == "both") \
        else [args.mesh == "multipod"]

    n_fail, passes = 0, {}
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_one(arch, shape,
                              mesh=make_production_mesh(multi_pod=mp),
                              fed2=args.fed2,
                              swa_override=args.swa_override,
                              outdir=args.out, passes=passes)
                n_fail += rec["status"] == "error"
            passes.clear()
    print(f"done; {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
