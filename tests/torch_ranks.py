"""Rank bodies of the multi-rank tests (``tests/test_torch_ranks_*.py``).

``launch.mesh.spawn`` starts each rank with the ``spawn`` method, which
imports the rank's function by module path. These live here, apart from
the test files, so that a rank imports torch and the port only, never
jax (whose import would double a rank's start-up). Every rank runs on
one intra-op thread: the suite's xdist workers share the cores.
"""
import contextlib
import dataclasses
import json
import os
import shutil
import types

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import fusion
from repro_torch.fl import capacity, engine, robust, runtime, scenarios
from repro_torch.fl.runtime import run_federated
from repro_torch.kernels.local_step import local_step
from repro_torch.launch import collectives, train
from repro_torch.launch.mesh import make_rank_mesh
from repro_torch.models import moe, moe_ep
from repro_torch.models.module import FlatLayout, Segments, tree_map


def _cpu(tree):
    return tree_map(lambda t: torch.as_tensor(t).detach().cpu().clone(),
                    tree)


@contextlib.contextmanager
def rounds_traced():
    """Within the block, every sync round of ``run_federated`` (a tiered
    one too) records its new global (a params tree), and the last round
    its server state and the population's client rows (CPU tensors;
    flat; an out-of-core store's gathered)."""
    seen = {"globals": [], "server": None, "clients": None}
    run_round = runtime.run_sampled_round
    run_tiered = capacity.run_tiered_round

    def spying(fn):
        def spy(eng, pop, *args, **kw):
            server, glob = fn(eng, pop, *args, **kw)
            layout = getattr(eng, "full", eng).layout
            seen["globals"].append(_cpu(layout.unflatten(glob)))
            seen["server"] = _cpu(server)
            seen["clients"] = _cpu(
                pop.clients if pop.store.in_memory
                else pop.gather(np.arange(pop.size)))
            return server, glob
        return spy
    runtime.run_sampled_round = spying(run_round)
    capacity.run_tiered_round = spying(run_tiered)
    try:
        yield seen
    finally:
        runtime.run_sampled_round = run_round
        capacity.run_tiered_round = run_tiered


def fl_inputs(argv, eval_batch):
    """The CLI's ``--mode fl`` run of ``argv``: (task, FLConfig at
    ``eval_batch``, parts, get_batch, test batches, use_local_kernel)."""
    args = train.parse_args(argv)
    task, fl, parts, get_batch, test = train.fl_inputs(args)
    fl = dataclasses.replace(fl, eval_batch=eval_batch)
    return task, fl, parts, get_batch, test, args.use_local_kernel


def run_fl(argv, eval_batch, init, mesh=None, **kw) -> dict:
    """One run of ``argv`` from the reference's ``init`` (numpy), on
    ``mesh`` (None: one process on the CPU), ``kw`` passed on to
    ``run_federated`` (``latency``, ``checkpoint_dir``, ``resume``): its
    final params (a CPU tree), accuracies, confusion counts, each
    round's global, the last round's server state and client rows
    (``rounds_traced``), an async run's events (participants, staleness,
    simulated times), and this process's local_step launches and
    collectives."""
    task, fl, parts, get_batch, test, local = fl_inputs(argv, eval_batch)
    if mesh is not None:
        mesh.counts.reset()
    before = local_step.launches
    with rounds_traced() as seen:
        h = run_federated(task, fl, parts, get_batch, test, device="cpu",
                          mesh=mesh, use_local_kernel=local,
                          init_params=convert.to_port(init), **kw)
    return {"final": tree_map(lambda t: t.detach().cpu(),
                              h["final_params"]),
            "acc": h["acc"], "confusion": h["confusion"],
            "globals": seen["globals"], "server": seen["server"],
            "clients": seen["clients"],
            "events": {k: h[k] for k in ("participants", "staleness",
                                         "sim_time", "local_tiles")
                       if k in h},
            "local_step": local_step.launches - before,
            "collectives": None if mesh is None else mesh.counts.as_dict()}


def dry_round_counts(argv) -> dict:
    """The dry-run's prediction of what each rank of a (2, 1) mesh
    issues in one round of the CLI run ``argv``: rank 0's program of the
    round (``fl/engine.lower_round``'s ``rank``, run once on meta), times
    the round's cohort tiles. ``Counts.as_dict()``'s keys."""
    import math

    from repro_torch.launch import fl_dryrun
    from repro_torch.launch.mesh import AXES, Mesh
    task, fl, *_ = fl_inputs(argv, 1)
    step = engine.lower_round(task, fl, Mesh(AXES, (2, 1)),
                              fl_dryrun._batch_elems("cnn", fl.batch_size,
                                                     0),
                              local_steps=fl.steps_per_epoch)
    tiles = math.ceil(fl.population / fl.cohort_size)
    c = fl_dryrun.rank_counts(step).as_dict()
    return {k: {kind: tiles * n for kind, n in d.items()}
            for k, d in c.items()}


def measured_round_counts(counts, rounds, eval_bytes) -> dict:
    """A rank's measured ``counts`` (``Counts.as_dict()``) of ``rounds``
    rounds as one round's, less the eval's one all-reduce of
    ``eval_bytes`` a round (not part of a round record)."""
    out = {}
    for k, d in counts.items():
        out[k] = {}
        for kind, n in d.items():
            assert n % rounds == 0, (k, kind, n, rounds)
            out[k][kind] = n // rounds
    out["calls"]["all_reduce"] -= 1
    for k in ("bytes", "result"):
        out[k]["all_reduce"] -= eval_bytes
    return out


def checkpoint_listing(path) -> dict:
    """A checkpoint directory's files (the clients' shard files under
    ``clients/``) and its manifest."""
    files = sorted(os.path.relpath(os.path.join(d, f), path)
                   for d, _, fs in os.walk(path) for f in fs)
    with open(os.path.join(path, "manifest.json")) as f:
        return {"files": files, "manifest": json.load(f)}


def case_rank(mesh, cases) -> list:
    """Each case of ``cases`` on this rank: a dict with ``argv``,
    ``eval_batch``, ``init`` and ``kw`` (``run_fl``'s), and optionally
    ``snapshot``, a path where rank 0 copies the run's checkpoint
    directory once the run is over. Each result carries the listing of
    the run's checkpoint directory (``checkpoint_listing``), if any."""
    torch.set_num_threads(1)
    out = []
    for case in cases:
        kw = case.get("kw", {})
        res = run_fl(case["argv"], case["eval_batch"], case["init"], mesh,
                     **kw)
        ck = kw.get("checkpoint_dir")
        if ck is not None:
            res["checkpoint"] = checkpoint_listing(ck)
            if case.get("snapshot") and mesh.rank == 0:
                shutil.copytree(ck, case["snapshot"])
        out.append(res)
    return out


def fl_rank(mesh, runs) -> list:
    """Each (argv, eval_batch, init) of ``runs`` on this rank."""
    torch.set_num_threads(1)
    return [run_fl(argv, eval_batch, init, mesh)
            for argv, eval_batch, init in runs]


def run_spec(spec, mesh=None, outdir=None) -> dict:
    """``run_scenario(spec)`` from the port's seeded init on the CPU, on
    ``mesh``: the record (a dict, walls dropped), each round's global,
    and the collectives."""
    if mesh is not None:
        mesh.counts.reset()
    with rounds_traced() as seen:
        rec = scenarios.run_scenario(spec, mesh=mesh, device="cpu",
                                     outdir=outdir)
    rec = {k: v for k, v in rec.to_dict().items()
           if k not in ("wall", "wall_total")}
    return {"record": rec, "globals": seen["globals"],
            "collectives": None if mesh is None else mesh.counts.as_dict()}


def spec_rank(mesh, specs, outdir) -> list:
    """Each spec of ``specs`` on this rank, its record written under
    ``outdir``/rank<r> (rank 0 only writes)."""
    torch.set_num_threads(1)
    return [run_spec(spec, mesh, f"{outdir}/rank{mesh.rank}")
            for spec in specs]


def robust_fuse(case, shard=None):
    """One reducing-rule fusion ``case`` = (rule spec, grouped, fp32 rows
    (N, 12), bf16-valued rows (N, 4), weights (N,), presence rows (N, 2)
    or None) of a two-segment (fp32 + bf16) cohort through
    ``paired_average`` (grouped) or ``fedavg``: on the whole cohort, or
    on ``shard``'s block of rows."""
    spec, grouped, a, b, w, gw = case
    rows = slice(None) if shard is None else slice(shard.lo, shard.hi)
    stacked = Segments([torch.as_tensor(a)[rows],
                        torch.as_tensor(b).to(torch.bfloat16)[rows]])
    rule = robust.parse_robust(spec)
    if not grouped:
        return fusion.fedavg(stacked, torch.as_tensor(w), robust=rule,
                             shard=shard)
    layout = FlatLayout({"a": torch.zeros(2, 6),
                         "b": torch.zeros(4, dtype=torch.bfloat16)})
    axes = {"a": fusion.GroupAxis(0, 2), "b": None}
    return fusion.paired_average(stacked, layout, axes,
                                 weights=torch.as_tensor(w),
                                 group_weights=gw, robust=rule, shard=shard)


def robust_fuse_rank(mesh, cases) -> list:
    """Each ``robust_fuse`` case on this rank's block of the cohort
    (the engine's ``RowShard``), with the collectives it ran."""
    torch.set_num_threads(1)
    out = []
    for case in cases:
        mesh.counts.reset()
        shard = engine._row_shard(
            types.SimpleNamespace(cohort_size=len(case[4])), mesh)
        got = robust_fuse(case, shard)
        out.append((list(got), mesh.counts.as_dict()))
    return out


def axes_rank(mesh, runs, specs, fuse_cases, outdir) -> dict:
    """The axes file's whole spawn: ``fl_rank``'s runs, ``spec_rank``'s
    scenario runs and ``robust_fuse_rank``'s fusion cases."""
    return {"fl": fl_rank(mesh, runs),
            "spec": spec_rank(mesh, specs, outdir),
            "fuse": robust_fuse_rank(mesh, fuse_cases)}


def moe_rank(mesh, cases, also) -> dict:
    """Each (config kwargs, params, x, capacity factor) of ``cases``
    through ``moe_apply_ep`` on this rank's data shard of x, on ``mesh``
    and then on the mesh of shape ``also`` over the same ranks; and
    every rank's id gathered over "model" on the first mesh. Returns
    {shape: [(y, aux), ...]} and the gather."""
    torch.set_num_threads(1)
    out = {}
    for m in (mesh, make_rank_mesh(also, device="cpu")):
        res = []
        for kw, p, x, cf in cases:
            cfg = moe.MoEConfig(**kw)
            bl = x.shape[0] // m.shape["data"]
            lo = m.coord("data") * bl
            xs = torch.as_tensor(x[lo:lo + bl])
            y, aux = moe_ep.moe_apply_ep(convert.lm_to_port(p), xs, cfg,
                                         mesh=m, capacity_factor=cf)
            res.append((y.numpy(), float(aux)))
        out[m.sizes] = res
    ids = collectives.all_gather(torch.tensor([mesh.rank]), mesh, "model")
    return {"out": out, "gathered": ids.reshape(-1).tolist(),
            "coords": mesh.coords}


def failing_rank(mesh) -> int:
    """Rank 1 raises; the others wait in a collective that never ends."""
    if mesh.rank == 1:
        raise ValueError("planted fault on rank 1")
    t = torch.zeros(1)
    collectives.all_reduce(t, mesh, "data")
    return int(np.asarray(t)[0])


def gather_by_owner(mesh, owners) -> list:
    """For each ``owner`` vector (n,), this rank's slots' rows (row s
    filled with s) gathered over "data" by ``all_gather_rows(owner=)``,
    with the collectives it ran."""
    out = []
    for owner in owners:
        mesh.counts.reset()
        mine = [s for s, o in enumerate(owner) if o == mesh.coord("data")]
        t = torch.tensor(mine, dtype=torch.float32)[:, None].repeat(1, 3)
        got = collectives.all_gather_rows(t, mesh, "data", len(owner),
                                          owner)
        out.append((got, mesh.counts.as_dict()))
    return out


def cases_specs_rank(mesh, cases, specs, outdir, owners=()) -> dict:
    """A file's whole spawn: ``case_rank``'s runs, ``spec_rank``'s
    scenario runs and the gathers by owner."""
    return {"runs": case_rank(mesh, cases),
            "spec": spec_rank(mesh, specs, outdir),
            "gather": gather_by_owner(mesh, owners)}


def serve_ranks(mesh, cases):
    """The sharded prefill loss and serving of each case on this rank.
    ``cases``: (cfg, params (the reference's layout, numpy), batch
    (numpy dict), run_serve's keywords). Per case: the loss and the
    collectives of one prefill step, run_serve's last logits, tokens,
    rows and cache share, the collectives of its decode steps (all of
    them, and their number), and the bytes the rank holds of the
    parameters beside ``per_device_bytes``."""
    from repro_torch.launch import serve, sharding, steps
    torch.set_num_threads(1)
    out = []
    for cfg, params, batch, kw in cases:
        shares = convert.lm_rank_to_port(params, cfg, mesh)
        full = convert.lm_to_port(params)
        lo, hi = sharding.batch_rows(mesh, len(batch["tokens"]))
        mesh.counts.reset()
        loss = steps.make_prefill_loss_step(cfg, mesh=mesh)(
            shares, {k: torch.as_tensor(v[lo:hi]) for k, v in batch.items()})
        prefill = mesh.counts.as_dict()
        mesh.counts.reset()
        res = serve.run_serve(cfg, device="cpu", init_params=full,
                              mesh=mesh, **kw)
        out.append({
            "loss": float(loss), "prefill_counts": prefill,
            "logits": res["logits"], "tokens": res["tokens"],
            "rows": res["rows"], "cache": _cpu(res["cache"]),
            "decode_counts": mesh.counts.as_dict(),
            "decode_steps": kw["prompt_len"] + kw["gen"],
            "held": sharding.tree_bytes(shares),
            "per_device": sharding.per_device_bytes(
                full, sharding.param_shardings(full, cfg, mesh), mesh)})
    return out
