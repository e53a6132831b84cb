"""The other methods of the sync round on a mesh of ranks: fedprox,
fednova, scaffold and fedma, and cohort tiling, each on 2 "data" ranks
(``launch.mesh.spawn``, gloo, ``device="cpu"``, every case in one
spawn) against the port's one-process round and the reference's
``mesh=None`` round, on the CLI's reduced VGG9 (tests/ranks_parity.py:
5 clients, so the cohort splits 3 + 2).

Tolerances, as in tests/test_torch_ranks_round.py: every leaf within
``RTOL`` = 1e-5 of that leaf's largest magnitude in the one-process run
after 1 and 2 rounds (the ranks sum the fusion's rows in another order;
measured up to 3e-7; FedMA's matching lands on the same permutations
and gives the same bits), and in the reference's run after 1 round (the
ranks' round-1 global, recorded in the 2-round run). Scaffold after 2
rounds is held at ``RTOL / (K * lr)``: its control update c_i = c_i - c
+ (x - y_i) / (K * lr) divides the round-1 round-off of y_i by K * lr
= 2 * 0.01, and round 2 steps along it (measured against one process:
2.4e-5 of the largest magnitude in the final params, 2.1e-4 and 2.9e-4
in c and the c_i rows). The ranks' globals are equal to the bit after
every round, and so are scaffold's server control variate and the
population's client rows across ranks.

Cohort tiling: ``--cohort-size 3`` on 5 clients runs each round as two
tiles (3 participants, then 2 and a zero-weight pad), each tile's rows
split 2 + 1 over the ranks.
"""
import numpy as np
import pytest
import torch

import ranks_parity as rp
import torch_ranks
from repro_torch.configs import vgg9
from repro_torch.fl import methods as methods_lib
from repro_torch.fl.engine import make_round_engine
from repro_torch.fl.runtime import FLConfig, cnn_task
from repro_torch.launch.mesh import RankMesh
from repro_torch.models.module import tree_leaves

TILE = ("--cohort-size", "3")
# name -> (method, flags, held against the reference)
CASES = {
    "fedprox": ("fedprox", (), True),
    "fedprox-local-kernel": ("fedprox", ("--use-local-kernel",), False),
    "fednova": ("fednova", (), True),
    "scaffold": ("scaffold", (), True),
    "fedma": ("fedma", (), True),
    "fedma-local-kernel": ("fedma", ("--use-local-kernel",), False),
    "tiling-fedavg": ("fedavg", TILE, True),
    "tiling-fed2": ("fed2", TILE, False),
    "tiling-fedma": ("fedma", TILE, False),
}
# collectives a round by kind: the eval's all-reduce, the fusion's
# all-reduce a tile (fedma's fuse gathers the rows instead), scaffold's
# gathered client rows
# scaffold's amplification of round-off: K local steps at the CLI's lr
K_LR = 2 * 0.01
CALLS = {"fedprox": (2, 0), "fednova": (2, 0), "scaffold": (2, 1),
         "fedma": (1, 1), "tiling-fedavg": (3, 0), "tiling-fed2": (3, 0),
         "tiling-fedma": (1, 2)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks():
    """Every case on 2 ranks of a (2, 1) mesh in one spawn: per case,
    each rank's result."""
    runs = [(rp.argv(m, f), rp.EVAL_BATCH, rp.init(m, f))
            for m, f, _ in CASES.values()]
    per_rank = rp.spawn_beside(torch_ranks.fl_rank, (runs,),
                               CASES.values())
    return {name: [r[i] for r in per_rank] for i, name in enumerate(CASES)}


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_one_process_and_reference(ranks, name):
    method, flags, against_reference = CASES[name]
    a, b = ranks[name]
    assert len(a["globals"]) == rp.ROUNDS
    for x, y in zip(a["globals"], b["globals"]):
        assert rp.same_bits(x, y)     # every rank ends with one global
    assert rp.same_bits(a["final"], b["final"]) and a["acc"] == b["acc"]
    one = rp.one_process(method, flags)
    rp.within(rp.ref_tree(a["globals"][0]), rp.ref_tree(one["globals"][0]))
    rtol = rp.RTOL / K_LR if method == "scaffold" else rp.RTOL
    rp.within(rp.ref_tree(a["final"]), rp.ref_tree(one["final"]), rtol)
    np.testing.assert_allclose(a["acc"], one["acc"],
                               atol=1.0 / (rp.TRAIN // 4) + 1e-9)
    if against_reference:
        rp.within(rp.ref_tree(a["globals"][0]), rp.reference(method, flags))
    # on CPU tensors the local_step wrapper takes its plain version
    assert a["local_step"] == b["local_step"] == 0


@pytest.mark.parametrize("name", list(CALLS))
def test_collectives_per_round(ranks, name):
    """All-reduces and all-gathers a round, by kind; a gather moves the
    longest block of rows (3 of 5, 2 of a tile of 3) of every dtype
    segment (one here)."""
    reduces, gathers = CALLS[name]
    res = ranks[name]
    m = sum(t.numel() for t in tree_leaves(res[0]["final"]))
    rows = 2 if name.startswith("tiling") else 3
    for r in res:
        c = r["collectives"]
        assert c["calls"] == {"all_reduce": reduces * rp.ROUNDS,
                              "all_to_all": 0,
                              "all_gather": gathers * rp.ROUNDS}
        assert c["bytes"]["all_gather"] == gathers * rp.ROUNDS * rows * 4 * m
        assert c["staged"] == {"all_reduce": 0, "all_to_all": 0,
                               "all_gather": 0}      # CPU tensors


# the eval's all-reduce a round: the (10, 10) float32 confusion counts
EVAL_BYTES = 10 * 10 * 4


@pytest.mark.parametrize("name", list(CASES))
def test_dry_prediction_equals_the_ranks_counts(ranks, name):
    """The dry-run's (2, 1) prediction of one round (rank 0's program on
    meta, times the round's tiles) equals what each gloo rank counted a
    round, the eval's all-reduce taken off: calls, bytes, result bytes
    (an all-gather's: 2 x the padded block) and staged bytes by kind."""
    method, flags, _ = CASES[name]
    want = torch_ranks.dry_round_counts(rp.argv(method, flags))
    for r in ranks[name]:
        assert torch_ranks.measured_round_counts(
            r["collectives"], rp.ROUNDS, EVAL_BYTES) == want
    gathers = want["calls"]["all_gather"]
    assert want["result"]["all_gather"] == 2 * want["bytes"]["all_gather"]
    assert gathers == (CALLS[name] if name in CALLS else CALLS[method])[1]


def test_scaffold_state_is_one_replica(ranks):
    """Scaffold's server control variate and the population's client
    rows: equal to the bit across ranks (each rank runs the one-process
    server step on the gathered rows), and within RTOL / (K * lr) of the
    one-process run's."""
    a, b = ranks["scaffold"]
    one = rp.one_process("scaffold")
    for key in ("server", "clients"):
        assert rp.same_bits(a[key], b[key]), key
        for x, y in zip(tree_leaves(a[key]), tree_leaves(one[key])):
            assert x.shape == y.shape and x.abs().max() > 0
            assert (x - y).abs().max() <= rp.RTOL / K_LR * y.abs().max()


def test_fedma_matches_once_on_every_rank(ranks):
    """FedMA's host matching runs on every rank on the gathered rows:
    the same global on both ranks, whole and tiled; untiled, the bits of
    the one-process run."""
    for name in ("fedma", "tiling-fedma"):
        a, b = ranks[name]
        assert rp.same_bits(a["final"], b["final"])
    assert rp.same_bits(ranks["fedma"][0]["final"],
                        rp.one_process("fedma")["final"])


def _mesh(data, coord):
    """A rank's mesh without a process group: enough to build an
    engine, which runs no collective."""
    return RankMesh(("data", "model"), (data, 1), rank=coord,
                    coords=(coord, 0), groups=(None, None))


@pytest.mark.parametrize("method", methods_lib.available())
def test_every_method_builds_on_ranks(method):
    """Each of the eight methods builds its engine on a rank of a
    2-rank mesh: this rank's 3 of 5 cohort rows, a row shard that
    reduces and gathers, the fusion kernel off."""
    cfg = vgg9.reduced() if method == "fed2" else vgg9.reduced(
        fed2_groups=0, norm="none")
    task = cnn_task(cfg)
    fl = FLConfig(population=5, method=method)
    engine = make_round_engine(task, fl, task.init_fn(torch.Generator()),
                               device="cpu", mesh=_mesh(2, 0))
    shard = engine.ctx.shard
    assert (shard.lo, shard.hi, shard.total) == (0, 3, 5)
    assert shard.gather is not None and not engine.ctx.use_kernel
    assert engine.cohort.shape[0] == 3 and engine.rows == slice(0, 3)


def test_tiled_round_splits_each_tile(ranks):
    """A tile of 3 slots over 2 ranks: 2 + 1 rows; 2 tiles a round."""
    task = cnn_task(vgg9.reduced())
    eng = make_round_engine(task, FLConfig(population=5, cohort_size=3),
                            task.init_fn(torch.Generator()), device="cpu",
                            mesh=_mesh(2, 1))
    assert eng.rows == slice(2, 3) and eng.cohort.shape[0] == 1
    c = ranks["tiling-fedavg"][1]["collectives"]["calls"]
    assert c["all_reduce"] == 3 * rp.ROUNDS
