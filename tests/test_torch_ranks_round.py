"""The sync round on a mesh of ranks (``run_federated(mesh=RankMesh)``):
the cohort split over 2 "data" ranks (``launch.mesh.spawn``, gloo,
``device="cpu"``, a ``file://`` store) against the port's one-process
round and the reference's ``mesh=None`` round, on the CLI's reduced
VGG9 (``--reduced``) from the reference's initial parameters
(``PRNGKey(0)``, converted by ``repro_torch.convert``).

The cohort is uneven: 5 clients over 2 ranks (3 and 2 rows). The eval
set has 3 tiles of ``EVAL_BATCH``, padded to 4 so that both ranks hold
2 (the second rank's last all padding).

Tolerances: every leaf of the final params within ``RTOL`` = 1e-5 of
that leaf's largest magnitude in the one-process port run after 2
rounds (the ranks sum the fusion's weighted rows in another order:
measured 1.2e-7 to 3.6e-7 of the largest), and in the reference's run
after 1 round (both packages compute in fp32 and sum convolutions and
the fusion in other orders: measured 5.8e-7 to 1.4e-6 of the largest,
a conv bias; after a second round the one-process port's fed2 is 2.6e-5
of its first conv bias (2.3e-8 of 8.9e-4) off the reference's, so the
reference is held at 1 round). Accuracies within one eval example: an
argmax may flip on a near-tie under fp32 round-off.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from repro.configs import vgg9 as jvgg9
from repro.fl import runtime as jrt
from repro_torch import convert
from repro_torch.core import fusion
from repro_torch.fl import evaluation
from repro_torch.fl.engine import make_round_engine
from repro_torch.fl.runtime import FLConfig, cnn_task
from repro_torch.launch.mesh import RankMesh, data_block, spawn
from repro_torch.models.module import Segments, tree_leaves

RTOL = 1e-5
ROUNDS, NODES, TRAIN, EVAL_BATCH = 2, 5, 200, 20
CASES = {"fed2": ("fed2", False), "fed2-local-kernel": ("fed2", True),
         "fedavg": ("fedavg", False), "fedavg-local-kernel": ("fedavg", True)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _argv(method, local_kernel=False, rounds=ROUNDS):
    return (["--mode", "fl", "--reduced", "--method", method, "--rounds",
             str(rounds), "--nodes", str(NODES), "--train-size", str(TRAIN),
             "--steps-per-epoch", "2", "--batch", "8", "--device", "cpu"]
            + (["--use-local-kernel"] if local_kernel else []))


def _jcfg(method):
    return (jvgg9.reduced() if method == "fed2"
            else jvgg9.reduced(fed2_groups=0, norm="none"))


@functools.lru_cache(maxsize=None)
def _init(method):
    task = jrt.cnn_task(_jcfg(method))
    return jax.tree_util.tree_map(np.asarray,
                                  task.init_fn(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _reference(method):
    """The reference's ``run_federated(mesh=None)`` on the CLI's inputs,
    1 round."""
    _, fl, parts, get_batch, test, _ = torch_ranks.fl_inputs(
        _argv(method, rounds=1), EVAL_BATCH)
    names = {f.name for f in dataclasses.fields(jrt.FLConfig)}
    jfl = jrt.FLConfig(**{f.name: getattr(fl, f.name)
                          for f in dataclasses.fields(fl)
                          if f.name in names})
    return jrt.run_federated(
        jrt.cnn_task(_jcfg(method)), jfl, parts,
        lambda s: {k: jnp.asarray(v) for k, v in get_batch(s).items()},
        test, mesh=None, use_kernel=False)


@pytest.fixture(scope="module")
def ranks():
    """Every case on 2 ranks of a (2, 1) mesh, for ROUNDS rounds and for
    1, in one spawn: per (case, rounds), each rank's result."""
    keys = [(name, ROUNDS) for name in CASES] + [("fed2", 1), ("fedavg", 1)]
    runs = [(_argv(*CASES[name], rounds=r), EVAL_BATCH,
             _init(CASES[name][0])) for name, r in keys]
    per_rank = spawn(torch_ranks.fl_rank, (2, 1), backend="gloo",
                     device="cpu", args=(runs,))
    return {key: [r[i] for r in per_rank] for i, key in enumerate(keys)}


@functools.lru_cache(maxsize=None)
def _one_process(name):
    method, lk = CASES[name]
    return torch_ranks.run_fl(_argv(method, lk), EVAL_BATCH, _init(method))


def _within(got, want, rtol=RTOL):
    """Every leaf of ``got`` within ``rtol`` of the largest |leaf| of
    ``want`` (two reference-layout numpy trees)."""
    fg = jax.tree_util.tree_flatten_with_path(got)[0]
    fw = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(fg) == len(fw)
    for (path, a), (_, b) in zip(fg, fw):
        b = np.asarray(b)
        assert a.shape == b.shape, jax.tree_util.keystr(path)
        err, scale = np.abs(a - b).max(), np.abs(b).max()
        assert err <= rtol * scale, (jax.tree_util.keystr(path), err, scale)


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_one_process_and_reference(ranks, name):
    """Against the one-process run of the case, and for the plain routes
    against the reference's."""
    checks = [(ROUNDS, _one_process(name))]
    if (name, 1) in ranks:
        checks.append((1, _reference(name)))
    for rounds, want in checks:
        a, b = ranks[name, rounds]
        # the replicated server step: both ranks hold the same global
        for x, y in zip(tree_leaves(a["final"]), tree_leaves(b["final"])):
            assert torch.equal(x, y)
        assert a["acc"] == b["acc"]
        final = want["final"] if rounds == ROUNDS else want["final_params"]
        _within(convert.to_reference(a["final"]),
                jax.tree_util.tree_map(np.asarray, final)
                if rounds == 1 else convert.to_reference(final))
        np.testing.assert_allclose(a["acc"], want["acc"],
                                   atol=1.0 / (TRAIN // 4) + 1e-9)
        # on CPU tensors the local_step wrapper takes its plain version
        # and launches nothing (chip_smoke.py counts each rank's)
        assert a["local_step"] == b["local_step"] == 0


def test_collectives_per_round(ranks):
    """Per round, one fusion all-reduce (one dtype segment) of the (M,)
    params and one eval all-reduce of the (10, 10) counts; nothing
    else."""
    for (name, rounds), res in ranks.items():
        m = sum(t.numel() for t in tree_leaves(res[0]["final"]))
        for r in res:
            c = r["collectives"]
            assert c["calls"] == {"all_reduce": 2 * rounds,
                                  "all_to_all": 0, "all_gather": 0}, name
            assert c["bytes"]["all_reduce"] == rounds * 4 * (m + 100)
            assert c["staged"]["all_reduce"] == 0   # CPU tensors


# the eval's all-reduce a round: the (10, 10) float32 confusion counts
EVAL_BYTES = 10 * 10 * 4


@pytest.mark.parametrize("key", [(name, ROUNDS) for name in CASES]
                         + [("fed2", 1), ("fedavg", 1)],
                         ids=lambda k: f"{k[0]}-{k[1]}")
def test_dry_prediction_equals_the_ranks_counts(ranks, key):
    """The dry-run's (2, 1) prediction of one round (rank 0's program on
    meta, nothing moved) equals what each gloo rank counted a round,
    the eval's all-reduce taken off: calls, bytes, result bytes and
    staged bytes by kind."""
    name, rounds = key
    want = torch_ranks.dry_round_counts(_argv(*CASES[name], rounds=rounds))
    assert want["calls"]["all_reduce"] == 1
    for r in ranks[key]:
        assert torch_ranks.measured_round_counts(
            r["collectives"], rounds, EVAL_BYTES) == want


def test_eval_counts_match_the_one_process_counts(ranks):
    """The eval's 3 tiles padded to 4 over 2 ranks: every round's
    confusion counts cover the 50 examples once, as the one-process
    run's do, and agree with them but for one example whose argmax may
    flip on a near-tie."""
    for name in CASES:
        one = _one_process(name)["confusion"]
        for r in ranks[name, ROUNDS]:
            assert len(r["confusion"]) == len(one) == ROUNDS
            for c, want in zip(r["confusion"], one):
                assert c.sum() == TRAIN // 4
                assert np.abs(c - want).sum() <= 2


def _mesh(data, coord):
    """A rank's mesh without a process group: enough for staging and
    the up-front refusals, which run no collective."""
    return RankMesh(("data", "model"), (data, 1), rank=coord,
                    coords=(coord, 0), groups=(None, None))


def test_eval_tiles_pad_to_a_multiple_of_the_data_size():
    x = np.arange(50, dtype=np.float32)[:, None]
    blocks = [evaluation.stage([{"x": x}], tile=EVAL_BATCH, device="cpu",
                               mesh=_mesh(2, i)) for i in range(2)]
    assert [b.n_tiles for b in blocks] == [2, 2]
    mask = torch.cat([b.mask for b in blocks])
    assert mask.sum() == 50 and mask[3].sum() == 0     # the pad tile
    one = evaluation.stage([{"x": x}], tile=EVAL_BATCH, device="cpu")
    assert one.n_tiles == 3
    torch.testing.assert_close(torch.cat([b.batches["x"] for b in blocks])
                               [:3], one.batches["x"], rtol=0, atol=0)
    assert [data_block(5, _mesh(2, i)) for i in range(2)] == [(0, 3),
                                                              (3, 5)]


@pytest.mark.parametrize("grouped", [False, True], ids=["fedavg", "fed2"])
def test_fusion_reduces_once_per_dtype_segment(grouped):
    """The sharded weighted mean of a two-segment (fp32 + bf16) cohort
    split 3 + 2 rows: one ``reduce`` a segment (each adds the other
    rank's fp32 partial sum, as the all-reduce does), and the result
    the one-process mean's, each segment in its dtype (fp32 within
    1e-6, bf16 within one rounding of the fp32 mean)."""
    from repro_torch.core.fusion import GroupAxis
    from repro_torch.models.module import FlatLayout
    gen = torch.Generator().manual_seed(0)
    tree = {"a": torch.zeros(2, 6), "b": torch.zeros(4, dtype=torch.bfloat16)}
    layout = FlatLayout(tree)
    rows = Segments([torch.randn(5, 12, generator=gen),
                     torch.randn(5, 4, generator=gen).to(torch.bfloat16)])
    axes = {"a": GroupAxis(0, 2) if grouped else None, "b": None}
    w = torch.rand(5, generator=gen)
    gw = torch.rand(5, 2, generator=gen) if grouped else None

    def fuse(stacked, shard=None):
        return fusion.paired_average(stacked, layout, axes, weights=w,
                                     group_weights=gw, shard=shard)

    seen = []
    fuse(Segments([s[3:] for s in rows]),
         fusion.RowShard(3, 5, 5, lambda t: seen.append(t.clone())))
    calls = []

    def reduce(t):
        t.add_(seen[len(calls)])
        calls.append(t.numel())

    got = fuse(Segments([s[:3] for s in rows]),
               fusion.RowShard(0, 3, 5, reduce))
    assert calls == [12, 4] and len(seen) == 2
    want = fuse(Segments([rows[0], rows[1].float()]))
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.bfloat16
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[1], want[1].to(torch.bfloat16), rtol=0,
                               atol=2 ** -7)


def test_host_mesh_equals_no_mesh():
    """``fed2_cifar_fl --mesh host`` is the ``--mesh none`` run: the
    (1, 1) mesh keeps one process, all the cohort's rows and the fusion
    kernel (chip_smoke.py counts its launches on the card)."""
    from repro_torch.configs import vgg9
    from repro_torch.examples import fed2_cifar_fl
    from repro_torch.launch.mesh import make_host_mesh
    task = cnn_task(vgg9.reduced())
    engine = make_round_engine(
        task, FLConfig(population=6), task.init_fn(torch.Generator()),
        device="cpu", mesh=make_host_mesh())
    assert engine.ctx.use_kernel and engine.ctx.shard is None
    assert engine.cohort.shape[0] == 6
    runs = {mesh: fed2_cifar_fl.run_fed2_cifar_fl(
        rounds=1, population=2, methods="fed2", mesh=mesh, device="cpu",
        log=None) for mesh in ("none", "host")}
    a, b = runs["none"]["fed2"], runs["host"]["fed2"]
    assert a["acc"] == b["acc"]
    for x, y in zip(tree_leaves(a["final_params"]),
                    tree_leaves(b["final_params"])):
        assert torch.equal(x, y)
