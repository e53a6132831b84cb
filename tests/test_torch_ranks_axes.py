"""The sync round's feature axes on a mesh of ranks: attacks (data and
model poisoning), robust rules, codecs, the bf16 local phase, one-shot
fusion and PAN alignment, each on 2 "data" ranks (``launch.mesh.spawn``,
gloo, ``device="cpu"``, every case in one spawn) against the port's
one-process round and the reference's ``mesh=None`` round, on the
CLI's reduced VGG9 (tests/ranks_parity.py: 5 clients, 2 attackers at
``--attack-fraction 0.4``, the cohort split 3 + 2); then
``run_scenario(mesh=)``, the reducing rules' sharded fusion and
``launch/scenarios.py --mesh host``.

Tolerances: every leaf within ``RTOL`` = 1e-5 of that leaf's largest
magnitude in the one-process run after 1 round and in the reference's
run after 1 round, as in tests/test_torch_ranks_round.py. After 2
rounds, within RTOL or within twice what one ulp of the init does to
the one-process run (``ranks_parity.within_spread``), whichever is
larger: under label flipping and the int8 codec a round-off change
crosses a ReLU or a quantization boundary in round 2, whatever the
change is (measured: the ranks and the one-ulp run both land 1.94e-3
of a conv leaf's largest magnitude off under label_flip, 1.02e-5
under int8; RTOL holds every other case). A reducing rule sorts the
gathered rows, so its rounds are the one-process bits. Two cases are
held otherwise:

- ``gauss_noise``: the port draws its noise from torch generators,
  another draw than the reference's (fl/attacks.py), so it is held
  against one process only, where each row's noise must be its cohort
  slot's (``test_gauss_noise_draws_each_slots_noise``).
- ``bfloat16`` (the bf16 local phase): after round 1 against one
  process at RTOL; after round 2 and against the reference at
  ``BF16_ATOL`` = 2^-7 absolute, tests/test_torch_axes.py's bound
  (each |w| here is below 1). Round 2 casts the fp32 global down to
  bf16, and the ranks' global differs from one process's by fp32
  round-off, which moves a coordinate across a bf16 rounding boundary
  by one bf16 ulp (2^-8 below 1.0); the two packages round bf16
  intermediates differently (ROADMAP Queue 3).
"""
import json
import os

import numpy as np
import pytest
import torch

import ranks_parity as rp
import torch_ranks
from repro_torch.configs import vgg9
from repro_torch.fl import attacks, scenarios
from repro_torch.fl.engine import make_round_engine
from repro_torch.fl.runtime import FLConfig, cnn_task
from repro_torch.launch import scenarios as launch_scenarios
from repro_torch.launch.mesh import RankMesh, data_block
from repro_torch.models.module import FlatLayout, tree_leaves

BF16_ATOL = 2.0 ** -7
ATK = ("--attack-fraction", "0.4")
BF16 = ("--compute-dtype", "bfloat16")
# name -> (method, flags, held against the reference)
CASES = {
    "label_flip": ("fedavg", ("--attack", "label_flip") + ATK, True),
    "sign_flip-trimmed_mean": ("fed2", ("--attack", "sign_flip(4)") + ATK
                               + ("--robust", "trimmed_mean(0.25)"), True),
    "scaled_update": ("fedavg", ("--attack", "scaled_update(10)") + ATK,
                      False),
    "gauss_noise": ("fedavg", ("--attack", "gauss_noise(1)") + ATK, False),
    "coordinate_median-fednova": ("fednova",
                                  ("--robust", "coordinate_median"), True),
    "norm_clip": ("fedavg", ("--robust", "norm_clip(1)"), True),
    "int8": ("fed2", ("--codec", "int8"), True),
    "topk": ("fedavg", ("--codec", "topk(0.1)"), False),
    "bf16": ("fed2", BF16, True),
    "bf16-local-kernel": ("fed2", BF16 + ("--use-local-kernel",), False),
    "one_shot": ("fedavg", ("--fed-mode", "one_shot"), False),
    "pan": ("fedavg", ("--alignment", "pan"), False),
}
# all-gathers a round (a reducing rule's, one dtype segment); every case
# has one eval all-reduce a round, and a fusion all-reduce unless a rule
# reduces
GATHERS = {"sign_flip-trimmed_mean": 1, "coordinate_median-fednova": 1}
SPECS = ("nxc2_fed2_signflip20_trim", "nxc2_fedma")
SMALL = dict(rounds=2, train_size=200, test_size=64, steps_per_epoch=2,
             batch_size=8)
RULES = ("coordinate_median", "trimmed_mean(0.25)")


def _fuse_cases():
    """(rule, grouped, fp32 rows, bf16-valued rows, weights, presence
    rows) over a 5-row cohort, drawn from a seed; ties in the bf16
    segment included."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((5, 12)).astype(np.float32)
    b = torch.tensor(rng.standard_normal((5, 4)),
                     dtype=torch.bfloat16).float().numpy()
    b[3] = b[1]
    w = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    gw = rng.uniform(0.0, 1.0, (5, 2)).astype(np.float32)
    return [(rule, grouped, a, b, w, gw if grouped else None)
            for rule in RULES for grouped in (False, True)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(name):
    return scenarios.get(name).override(**SMALL)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case, scenario and fusion case on 2 ranks in one spawn."""
    out = str(tmp_path_factory.mktemp("records"))
    runs = [(rp.argv(m, f), rp.EVAL_BATCH, rp.init(m, f))
            for m, f, _ in CASES.values()]
    got = rp.spawn_beside(torch_ranks.axes_rank,
                          (runs, [_spec(n) for n in SPECS], _fuse_cases(),
                           out),
                          CASES.values(), spread=True)
    fl = {name: [r["fl"][i] for r in got] for i, name in enumerate(CASES)}
    spec = {name: [r["spec"][i] for r in got]
            for i, name in enumerate(SPECS)}
    return {"fl": fl, "spec": spec, "fuse": [r["fuse"] for r in got],
            "out": out}


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_one_process_and_reference(ranks, name):
    method, flags, against_reference = CASES[name]
    a, b = ranks["fl"][name]
    rounds = 1 if name == "one_shot" else rp.ROUNDS
    assert len(a["globals"]) == rounds
    for x, y in zip(a["globals"], b["globals"]):
        assert rp.same_bits(x, y)     # every rank ends with one global
    assert rp.same_bits(a["final"], b["final"]) and a["acc"] == b["acc"]
    one = rp.one_process(method, flags)
    rp.within(rp.ref_tree(a["globals"][0]), rp.ref_tree(one["globals"][0]))
    bf16 = name.startswith("bf16")
    if bf16:
        rp.within(rp.ref_tree(a["final"]), rp.ref_tree(one["final"]), 0.0,
                  BF16_ATOL)
    else:
        rp.within_spread(a["final"], method, flags)
    np.testing.assert_allclose(a["acc"], one["acc"],
                               atol=1.0 / (rp.TRAIN // 4) + 1e-9)
    if against_reference:
        rp.within(rp.ref_tree(a["globals"][0]), rp.reference(method, flags),
                  *((0.0, BF16_ATOL) if bf16 else ()))
    assert a["local_step"] == b["local_step"] == 0


@pytest.mark.parametrize("name", list(CASES))
def test_collectives_per_round(ranks, name):
    """A reducing rule all-gathers each segment's rows in place of the
    fusion's all-reduce; every other axis keeps the plain round's
    collectives. One eval all-reduce a round."""
    gathers = GATHERS.get(name, 0)
    rounds = 1 if name == "one_shot" else rp.ROUNDS
    res = ranks["fl"][name]
    m = sum(t.numel() for t in tree_leaves(res[0]["final"]))
    for r in res:
        c = r["collectives"]
        assert c["calls"] == {"all_reduce": (2 - gathers) * rounds,
                              "all_to_all": 0,
                              "all_gather": gathers * rounds}
        assert c["bytes"]["all_gather"] == gathers * rounds * 3 * 4 * m


def test_sharded_reduction_is_the_one_process_reduction(ranks):
    """coordinate_median and trimmed_mean(0.25) on a cohort of an fp32
    and a bf16 segment split 3 + 2 over the ranks, through fedavg and
    through paired averaging under presence rows: each rank's result is
    the one-process reduction's to the bit, each segment in its dtype,
    after one all-gather a segment and no all-reduce."""
    for i, case in enumerate(_fuse_cases()):
        want = torch_ranks.robust_fuse(case)
        for per_rank in ranks["fuse"]:
            got, counts = per_rank[i]
            assert [g.dtype for g in got] == [torch.float32,
                                              torch.bfloat16]
            assert all(torch.equal(g, w) for g, w in zip(got, want)), case[:2]
            assert counts["calls"] == {"all_reduce": 0, "all_to_all": 0,
                                       "all_gather": 2}
            assert counts["bytes"]["all_gather"] == 3 * (12 * 4 + 4 * 2)


def test_gauss_noise_draws_each_slots_noise():
    """A rank's block of rows, poisoned with ``first`` its first cohort
    slot and its slice of the malicious row, gets the one-process
    cohort's poisoned rows to the bit: each row's noise is drawn for its
    cohort slot. Without ``first`` the second block draws the first
    block's slots' noise."""
    layout = FlatLayout({"w": torch.zeros(3, 4), "b": torch.zeros(5)})
    gen = torch.Generator().manual_seed(0)
    rows = torch.randn(5, layout.size, generator=gen)
    glob = torch.randn(layout.size, generator=gen)
    mal = np.array([1.0, 0.0, 1.0, 1.0, 1.0], np.float32)
    atk, key = attacks.get("gauss_noise", 1.0), attacks.round_key(0, 1)
    one = atk.poison_update(rows, glob, mal, key, layout)
    mesh = [_mesh(2, i) for i in range(2)]
    for m in mesh:
        lo, hi = data_block(5, m)
        got = atk.poison_update(rows[lo:hi], glob, mal[lo:hi], key, layout,
                                first=lo)
        assert torch.equal(got, one[lo:hi])
    lo, hi = data_block(5, mesh[1])
    local = atk.poison_update(rows[lo:hi], glob, mal[lo:hi], key, layout)
    assert not torch.equal(local, one[lo:hi])


@pytest.mark.parametrize("name", SPECS)
def test_run_scenario_on_ranks(ranks, name):
    """``run_scenario(spec, mesh=)`` of a spec at a small size: both
    ranks return the same record, rank 0 alone writes it, and it holds
    the ``mesh=None`` run's accuracies within one eval example a class
    and its globals within RTOL."""
    a, b = ranks["spec"][name]
    assert a["record"] == b["record"]
    for x, y in zip(a["globals"], b["globals"]):
        assert rp.same_bits(x, y)
    one = torch_ranks.run_spec(_spec(name))
    ra, ro = a["record"], one["record"]
    assert ra["rounds"] == ro["rounds"] == list(range(SMALL["rounds"]))
    assert {k: v for k, v in ra.items() if "acc" not in k} == \
        {k: v for k, v in ro.items() if "acc" not in k}
    np.testing.assert_allclose(ra["acc"], ro["acc"],
                               atol=1 / SMALL["test_size"] + 1e-9)
    for x, y in zip(a["globals"], one["globals"]):
        rp.within(rp.ref_tree(x), rp.ref_tree(y))
    path = f"scenario_{name}.json"
    assert os.path.exists(os.path.join(ranks["out"], "rank0", path))
    assert not os.path.exists(os.path.join(ranks["out"], "rank1", path))
    with open(os.path.join(ranks["out"], "rank0", path)) as f:
        assert json.load(f)["acc"] == ra["acc"]


def test_scenario_cli_mesh_host_equals_none(tmp_path):
    """``launch/scenarios.py --mesh host`` (the (1, 1) host mesh) writes
    the ``--mesh none`` records."""
    recs = {}
    for kind in ("none", "host"):
        out = tmp_path / kind
        recs[kind] = launch_scenarios.main(
            ["--scenarios", "nxc2_fedma", "--rounds", "1", "--train-size",
             "200", "--device", "cpu", "--mesh", kind, "--out", str(out)])
        with open(out / "scenario_nxc2_fedma.json") as f:
            rec = json.load(f)
        recs[kind] = {k: v for k, v in rec.items()
                      if k not in ("wall", "wall_total")}
    assert recs["host"] == recs["none"]


def _mesh(data, coord):
    """A rank's mesh without a process group: enough to build an
    engine, which runs no collective."""
    return RankMesh(("data", "model"), (data, 1), rank=coord,
                    coords=(coord, 0), groups=(None, None))


@pytest.mark.parametrize("kw", [
    {"attack": "sign_flip(4)", "attack_fraction": 0.4},
    {"attack": "label_flip", "attack_fraction": 0.4},
    {"robust": "coordinate_median"},
    {"codec": "int8"},
    {"compute_dtype": "bfloat16"},
    {"mode": "one_shot"},
    {"alignment": "pan", "method": "fedavg"},
], ids=["attack", "data-poisoning", "robust", "codec", "bf16", "one-shot",
        "alignment"])
def test_every_axis_builds_on_ranks(kw):
    """Each axis of the sync round builds its engine on a rank: the
    rank's 2 of 5 rows, its bf16 shadow sized to them."""
    cfg = vgg9.reduced(fed2_groups=0, norm="none") \
        if kw.get("method") == "fedavg" else vgg9.reduced()
    task = cnn_task(cfg)
    fl = FLConfig(population=5, **kw)
    engine = make_round_engine(task, fl, task.init_fn(torch.Generator()),
                               device="cpu", mesh=_mesh(2, 1))
    assert engine.rows == slice(3, 5) and engine.cohort.shape[0] == 2
    if engine.shadow is not None:
        assert engine.shadow.shape == (2, engine.layout.size)
