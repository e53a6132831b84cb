"""Rank bodies of the multi-rank tests (``tests/test_torch_ranks_*.py``).

``launch.mesh.spawn`` starts each rank with the ``spawn`` method, which
imports the rank's function by module path. These live here, apart from
the test files, so that a rank imports torch and the port only, never
jax (whose import would double a rank's start-up). Every rank runs on
one intra-op thread: the suite's xdist workers share the cores.
"""
import dataclasses

import numpy as np
import torch

from repro_torch import convert
from repro_torch.fl.runtime import run_federated
from repro_torch.kernels.local_step import local_step
from repro_torch.launch import collectives, train
from repro_torch.launch.mesh import make_rank_mesh
from repro_torch.models import moe, moe_ep
from repro_torch.models.module import tree_map


def fl_inputs(argv, eval_batch):
    """The CLI's ``--mode fl`` run of ``argv``: (task, FLConfig at
    ``eval_batch``, parts, get_batch, test batches, use_local_kernel)."""
    args = train.parse_args(argv)
    task, fl, parts, get_batch, test = train.fl_inputs(args)
    fl = dataclasses.replace(fl, eval_batch=eval_batch)
    return task, fl, parts, get_batch, test, args.use_local_kernel


def run_fl(argv, eval_batch, init, mesh=None) -> dict:
    """One run of ``argv`` from the reference's ``init`` (numpy), on
    ``mesh`` (None: one process on the CPU): its final params (a CPU
    tree), accuracies, confusion counts, and this process's local_step
    launches and collectives."""
    task, fl, parts, get_batch, test, local = fl_inputs(argv, eval_batch)
    if mesh is not None:
        mesh.counts.reset()
    before = local_step.launches
    h = run_federated(task, fl, parts, get_batch, test, device="cpu",
                      mesh=mesh, use_local_kernel=local,
                      init_params=convert.to_port(init))
    return {"final": tree_map(lambda t: t.detach().cpu(),
                              h["final_params"]),
            "acc": h["acc"], "confusion": h["confusion"],
            "local_step": local_step.launches - before,
            "collectives": None if mesh is None else mesh.counts.as_dict()}


def fl_rank(mesh, runs) -> list:
    """Each (argv, eval_batch, init) of ``runs`` on this rank."""
    torch.set_num_threads(1)
    return [run_fl(argv, eval_batch, init, mesh)
            for argv, eval_batch, init in runs]


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
