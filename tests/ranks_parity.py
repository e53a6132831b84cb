"""Shared parts of the sync-round tests on ranks
(``tests/test_torch_ranks_methods.py``, ``tests/test_torch_ranks_axes.py``):
the CLI's reduced VGG9 runs of a case, the reference's ``mesh=None``
round from the same inputs, and the tolerance checks.

A case is a method and the CLI flags that follow it. Every run is
``--reduced`` with 5 clients, so the cohort splits 3 + 2 over 2 "data"
ranks, 2 local steps of batch 8, 200 training examples and eval tiles
of ``EVAL_BATCH`` (3 tiles, padded to 4 on 2 ranks), from the
reference's ``PRNGKey(0)`` initial parameters of the case's model.
"""
import concurrent.futures
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_ranks
from repro.configs import vgg9 as jvgg9
from repro.fl import alignment as jalignment
from repro.fl import methods as jmethods
from repro.fl import runtime as jrt
from repro_torch import convert
from repro_torch.launch import train
from repro_torch.launch.mesh import spawn
from repro_torch.models.module import tree_leaves

RTOL = 1e-5
ROUNDS, NODES, TRAIN, EVAL_BATCH = 2, 5, 200, 20


def argv(method, flags=(), rounds=ROUNDS):
    return (["--mode", "fl", "--reduced", "--method", method, "--rounds",
             str(rounds), "--nodes", str(NODES), "--train-size", str(TRAIN),
             "--steps-per-epoch", "2", "--batch", "8", "--device", "cpu"]
            + list(flags))


def reference_model(method, flags=()):
    """The reference's model config of the case, through its alignment
    rule as its CLI builds it."""
    args = train.parse_args(argv(method, flags))
    return jalignment.build_model_config(
        jalignment.get(args.alignment), jmethods.get(method),
        grouped_fn=jvgg9.reduced,
        plain_fn=lambda: jvgg9.reduced(fed2_groups=0, norm="none"))


def init(method, flags=()):
    """The reference's initial parameters of the case's model (numpy)."""
    return _init(reference_model(method, flags))


@functools.lru_cache(maxsize=None)
def _init(cfg):
    task = jrt.cnn_task(cfg)
    return jax.tree_util.tree_map(np.asarray,
                                  task.init_fn(jax.random.PRNGKey(0)))


def spawn_beside(fn, args, cases, spread=False):
    """``fn`` on 2 ranks of a (2, 1) mesh (gloo, the CPU), while this
    process runs each (method, flags, against the reference) of
    ``cases`` in one process (with ``spread``, from the init and from
    one ulp above it) and, where asked, the reference's round (all
    cached), the references two at a time: the ranks and the jit
    compiles overlap. Returns each rank's result."""
    cases = list(cases)
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        ranks = pool.submit(spawn, fn, (2, 1), backend="gloo",
                            device="cpu", args=args)
        refs = [pool.submit(reference, m, f) for m, f, ref in cases if ref]
        try:
            for method, flags, _ in cases:
                one_process(method, flags)
                if spread:
                    one_ulp(method, flags)
            for r in refs:
                r.result()
        finally:
            per_rank = ranks.result()
    return per_rank


@functools.lru_cache(maxsize=None)
def reference(method, flags=()):
    """The reference's ``run_federated(mesh=None)`` on the CLI's inputs,
    1 round: its final params (numpy, the reference's layout)."""
    _, fl, parts, get_batch, test, _ = torch_ranks.fl_inputs(
        argv(method, flags, rounds=1), EVAL_BATCH)
    names = {f.name for f in dataclasses.fields(jrt.FLConfig)}
    jfl = jrt.FLConfig(**{f.name: getattr(fl, f.name)
                          for f in dataclasses.fields(fl)
                          if f.name in names})
    h = jrt.run_federated(
        jrt.cnn_task(reference_model(method, flags)), jfl, parts,
        lambda s: {k: jnp.asarray(v) for k, v in get_batch(s).items()},
        test, mesh=None, use_kernel=False)
    return jax.tree_util.tree_map(np.asarray, h["final_params"])


@functools.lru_cache(maxsize=None)
def one_process(method, flags=()):
    """The port's one-process run of the case, ROUNDS rounds."""
    return torch_ranks.run_fl(argv(method, flags), EVAL_BATCH,
                              init(method, flags))


@functools.lru_cache(maxsize=None)
def one_ulp(method, flags=()):
    """The port's one-process run of the case from its initial
    parameters moved up by one ulp (``np.nextafter``): beside
    ``one_process``, the run's own sensitivity to round-off."""
    up = jax.tree_util.tree_map(
        lambda a: np.nextafter(a, np.inf).astype(a.dtype),
        init(method, flags))
    return torch_ranks.run_fl(argv(method, flags), EVAL_BATCH, up)


def within_spread(got, method, flags=()):
    """``got``'s final params against the one-process run's: each leaf
    within RTOL of its largest magnitude or within twice the distance
    that one ulp of the init moves that leaf (``one_ulp``), whichever is
    larger. A ReLU, pooling or quantization boundary that a round-off
    change crosses moves a coordinate by a finite step, and any
    perturbation (the ranks' order of summation, or an ulp of the init)
    crosses it alike."""
    want = ref_tree(one_process(method, flags)["final"])
    ulp = ref_tree(one_ulp(method, flags)["final"])
    fg = jax.tree_util.tree_flatten_with_path(ref_tree(got))[0]
    for (path, a), b, u in zip(fg, jax.tree_util.tree_leaves(want),
                               jax.tree_util.tree_leaves(ulp)):
        err, scale = np.abs(a - b).max(), np.abs(b).max()
        assert err <= max(RTOL * scale, 2 * np.abs(u - b).max()), (
            jax.tree_util.keystr(path), err, scale)


def within(got, want, rtol=RTOL, atol=0.0):
    """Every leaf of ``got`` within ``rtol`` of the largest |leaf| of
    ``want`` (plus ``atol``), two reference-layout numpy trees."""
    fg = jax.tree_util.tree_flatten_with_path(got)[0]
    fw = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(fg) == len(fw)
    for (path, a), (_, b) in zip(fg, fw):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, jax.tree_util.keystr(path)
        err, scale = np.abs(a - b).max(), np.abs(b).max()
        assert err <= rtol * scale + atol, (jax.tree_util.keystr(path),
                                            err, scale)


def same_bits(a, b) -> bool:
    """Two port trees equal to the bit, leaf by leaf."""
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def ref_tree(tree):
    """A port params tree in the reference's layout (numpy)."""
    return convert.to_reference(tree)
