"""Buffered-async federation on a mesh of ranks
(``run_federated(mode="async", mesh=RankMesh)``): every rank replays the
same event loop, each dispatch group's tile is split over 2 "data"
ranks (``launch.mesh.spawn``, gloo, ``device="cpu"``, every case in one
spawn) and each event fuses the rows where they were computed, on the
CLI's reduced VGG9 (tests/ranks_parity.py: 5 clients, 4 in flight, 2
local steps of batch 8) from the reference's initial parameters.

- 4 events of fed2 (``buffer_k`` 2, ``polynomial(0.5)``, the
  ``local_step`` route) and of fedavg (``buffer_k`` 3, which does not
  tile the axis) under ``pareto(1.5)``: both ranks end with one global
  and one history; the schedule (participants, staleness, simulated
  times, local tiles) is the one-process run's, and the final params
  within ``RTOL`` = 1e-5 of each leaf's largest magnitude or twice what
  one ulp of the init does to the one-process run, whichever is larger
  (``ranks_parity.within_spread``'s rule); against the reference's
  ``mesh=None`` run, tests/test_torch_async.py's rule: within
  ``PARAM_TOL`` = 1e-4 or twice the one-ulp sensitivity;
- with ``buffer_k`` = cohort, zero latency and the constant discount,
  async on ranks equals sync on ranks to the bit, for every
  async-eligible method;
- an event all-reduces once (one dtype segment) and its eval once; an
  event's rows lying on any ranks fuse to the one-process mean, and
  ``all_gather_rows(owner=)`` returns them in slot order;
- ``run_scenario(spec, mesh=)`` of the 5 tier and the 2 async
  scenarios at 2 rounds or events.
"""
import concurrent.futures
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ranks_parity as rp
import torch_ranks
from repro.fl import runtime as jrt
from repro_torch.core import fusion
from repro_torch.fl import engine, methods, scenarios
from repro_torch.launch.mesh import RankMesh, spawn
from repro_torch.models.module import FlatLayout, tree_leaves

PARAM_TOL = 1e-4
INFLIGHT = ("--cohort-size", "4", "--sampler", "uniform")
ASYNC = INFLIGHT + ("--fed-mode", "async")
# name -> (method, flags, latency, events)
RUNS = {
    "fed2-k2": ("fed2", ASYNC + ("--buffer-k", "2", "--staleness",
                                 "polynomial(0.5)", "--use-local-kernel"),
                "pareto(1.5)", 4),
    "fedavg-k3": ("fedavg", ASYNC + ("--buffer-k", "3", "--staleness",
                                     "polynomial(0.5)"),
                  "pareto(1.5)", 4),
}
ELIGIBLE = [m for m in methods.available()
            if methods.get(m).async_eligible]
# buffer_k = cohort at zero latency, and the sync run it must equal
for _m in ELIGIBLE:
    RUNS[f"{_m}-kc"] = (_m, ASYNC, "zero", 2)
    RUNS[f"{_m}-sync"] = (_m, INFLIGHT, "zero", 2)
OWNERS = ((0, 1, 0, 1), (1, 0, 0), (0, 0, 0), (1, 1, 0, 1, 0))
# the registered tier and async scenarios, and their collectives a round
# or event: one a tier (every tier's tile splits 1 + 1) or an event's
# fusion, one an eval
SPECS = {"nxc2_fedavg_tiers": 4, "nxc2_fed2_tiers": 4,
         "nxc2_fed2_tiers_cal": 4, "dir05_fed2_tiers": 4,
         "dir05_fedavg_tiers": 4, "nxc2_fedavg_async": 2,
         "nxc2_fed2_async": 2}
SMALL = dict(rounds=2, train_size=200, test_size=64, steps_per_epoch=2,
             batch_size=8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _argv(name):
    method, flags, _, events = RUNS[name]
    return rp.argv(method, flags, rounds=events)


def _kw(name):
    return {"latency": RUNS[name][2]}


def _case(name):
    method, flags, _, _ = RUNS[name]
    return {"argv": _argv(name), "eval_batch": rp.EVAL_BATCH,
            "init": rp.init(method, flags), "kw": _kw(name)}


@functools.lru_cache(maxsize=None)
def _one_process(name, ulp=False):
    """The port's one-process run of ``name``, from the init or from one
    ulp above it."""
    method, flags, _, _ = RUNS[name]
    init = rp.init(method, flags)
    if ulp:
        init = jax.tree_util.tree_map(
            lambda a: np.nextafter(a, np.inf).astype(a.dtype), init)
    return torch_ranks.run_fl(_argv(name), rp.EVAL_BATCH, init,
                              **_kw(name))


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's ``run_federated(mesh=None)`` of ``name`` on the
    CLI's inputs: its history and final params (numpy)."""
    method, flags, latency, _ = RUNS[name]
    _, fl, parts, get_batch, test, _ = torch_ranks.fl_inputs(
        _argv(name), rp.EVAL_BATCH)
    names = {f.name for f in dataclasses.fields(jrt.FLConfig)}
    jfl = jrt.FLConfig(**{f.name: getattr(fl, f.name)
                          for f in dataclasses.fields(fl)
                          if f.name in names})
    h = jrt.run_federated(
        jrt.cnn_task(rp.reference_model(method, flags)), jfl, parts,
        lambda s: {k: jnp.asarray(v) for k, v in get_batch(s).items()},
        test, mesh=None, use_kernel=False, latency=latency)
    return {k: h[k] for k in ("participants", "staleness", "sim_time")}, \
        jax.tree_util.tree_map(np.asarray, h["final_params"])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every run, gather and the scenario on 2 ranks in one spawn, the
    one-process runs and the reference's beside it."""
    out = str(tmp_path_factory.mktemp("records"))
    specs = [scenarios.get(n).override(**SMALL) for n in SPECS]
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        got = pool.submit(spawn, torch_ranks.cases_specs_rank, (2, 1),
                          backend="gloo", device="cpu",
                          args=([_case(n) for n in RUNS], specs, out,
                                OWNERS))
        refs = [pool.submit(_reference, n) for n in ("fed2-k2",
                                                     "fedavg-k3")]
        try:
            for name in ("fed2-k2", "fedavg-k3"):
                _one_process(name)
                _one_process(name, ulp=True)
            one_spec = [torch_ranks.run_spec(spec) for spec in specs]
            for r in refs:
                r.result()
        finally:
            per_rank = got.result()
    return {"runs": {n: [r["runs"][i] for r in per_rank]
                     for i, n in enumerate(RUNS)},
            "gather": [r["gather"] for r in per_rank],
            "spec": {n: [r["spec"][i] for r in per_rank]
                     for i, n in enumerate(SPECS)},
            "one_spec": dict(zip(SPECS, one_spec)), "out": out}


def _within_spread(got, name):
    want = rp.ref_tree(_one_process(name)["final"])
    ulp = rp.ref_tree(_one_process(name, ulp=True)["final"])
    fg = jax.tree_util.tree_flatten_with_path(rp.ref_tree(got))[0]
    for (path, a), b, u in zip(fg, jax.tree_util.tree_leaves(want),
                               jax.tree_util.tree_leaves(ulp)):
        err, scale = np.abs(a - b).max(), np.abs(b).max()
        assert err <= max(rp.RTOL * scale, 2 * np.abs(u - b).max()), (
            jax.tree_util.keystr(path), err, scale)


def _same_events(a, b):
    assert a["staleness"] == b["staleness"]
    assert a["sim_time"] == b["sim_time"]
    for x, y in zip(a["participants"], b["participants"], strict=True):
        np.testing.assert_array_equal(x, np.asarray(y))


@pytest.mark.parametrize("name", ["fed2-k2", "fedavg-k3"])
def test_async_on_ranks_matches_one_process(ranks, name):
    a, b = ranks["runs"][name]
    assert rp.same_bits(a["final"], b["final"]) and a["acc"] == b["acc"]
    _same_events(a["events"], b["events"])
    one = _one_process(name)
    _same_events(a["events"], one["events"])
    assert a["events"]["local_tiles"] == one["events"]["local_tiles"]
    assert any(s for ev in a["events"]["staleness"] for s in ev)
    _within_spread(a["final"], name)
    np.testing.assert_allclose(a["acc"], one["acc"],
                               atol=1.0 / (rp.TRAIN // 4) + 1e-9)


@pytest.mark.parametrize("name", ["fed2-k2", "fedavg-k3"])
def test_async_on_ranks_matches_reference(ranks, name):
    a = ranks["runs"][name][0]
    events, want = _reference(name)
    _same_events(a["events"], events)
    flat = lambda t: np.concatenate(          # noqa: E731
        [np.ravel(x) for x in jax.tree_util.tree_leaves(t)])
    one = flat(rp.ref_tree(_one_process(name)["final"]))
    sensitivity = np.abs(
        one - flat(rp.ref_tree(_one_process(name, ulp=True)["final"]))).max()
    diff = np.abs(flat(rp.ref_tree(a["final"])) - flat(want)).max()
    assert diff <= max(PARAM_TOL, 2 * sensitivity), (diff, sensitivity)


@pytest.mark.parametrize("method", ELIGIBLE)
def test_infinite_buffer_on_ranks_is_the_sync_ranks_run(ranks, method):
    """buffer_k = cohort, zero latency, constant discount: every event
    is a sync round's cohort, its rows the ranks' blocks."""
    asyn, sync = ranks["runs"][f"{method}-kc"], ranks["runs"][
        f"{method}-sync"]
    for a, s in zip(asyn, sync):
        assert all(torch.isfinite(t).all() for t in tree_leaves(a["final"]))
        assert rp.same_bits(a["final"], s["final"])
        assert a["acc"] == s["acc"]
        assert a["events"]["staleness"] == [[0] * 4] * 2
        assert a["collectives"] == s["collectives"]


@pytest.mark.parametrize("name", ["fed2-k2", "fedavg-k3"])
def test_collectives_per_event(ranks, name):
    """An event fuses with one all-reduce of the whole flat vector (one
    dtype segment) and evaluates with one: nothing is gathered, on
    either rank, whatever rows it holds."""
    events = RUNS[name][3]
    res = ranks["runs"][name]
    m = sum(t.numel() for t in tree_leaves(res[0]["final"]))
    for r in res:
        c = r["collectives"]
        assert c["calls"] == {"all_reduce": 2 * events, "all_to_all": 0,
                              "all_gather": 0}
        assert c["bytes"]["all_reduce"] > events * 4 * m
        assert c["staged"] == {"all_reduce": 0, "all_to_all": 0,
                               "all_gather": 0}


def test_gather_by_owner_is_slot_order(ranks):
    """``all_gather_rows(owner=)``: each rank's slots, in any pattern
    (none at all on one rank included), come back in slot order on
    every rank after one all-gather."""
    for per_rank in ranks["gather"]:
        for owner, (got, counts) in zip(OWNERS, per_rank):
            n = len(owner)
            want = torch.arange(n, dtype=torch.float32)[:, None].repeat(1, 3)
            assert torch.equal(got, want), owner
            assert counts["calls"]["all_gather"] == 1
            longest = max(np.bincount(owner, minlength=2))
            assert counts["bytes"]["all_gather"] == longest * 3 * 4


def _mesh(coord):
    return RankMesh(("data", "model"), (2, 1), rank=coord,
                    coords=(coord, 0), groups=(None, None))


@pytest.mark.parametrize("owner", OWNERS, ids=str)
def test_event_rows_fuse_where_they_lie(owner):
    """An event whose rows lie on the ranks as ``owner`` says: each
    rank's partial sum over its slots (``engine.slot_shard``; with no
    process group the reduce is the identity), added up, is the
    one-process weighted mean, and paired averaging's under presence
    rows, within 1e-6."""
    n = len(owner)
    gen = torch.Generator().manual_seed(len(owner))
    rows = torch.randn(n, 16, generator=gen)
    w = torch.rand(n, generator=gen) + 0.5
    gw = torch.rand(n, 2, generator=gen)
    layout = FlatLayout({"a": torch.zeros(2, 6), "b": torch.zeros(4)})
    axes = {"a": fusion.GroupAxis(0, 2), "b": None}

    def fuse(stacked, shard=None):
        return (fusion.fedavg(stacked, w, shard=shard),
                fusion.paired_average(stacked, layout, axes, weights=w,
                                      group_weights=gw, shard=shard))
    want = fuse(rows)
    parts = []
    for coord in (0, 1):
        shard = engine.slot_shard(owner, _mesh(coord))
        mine = [s for s, o in enumerate(owner) if o == coord]
        assert list(shard.index) == mine and shard.total == n
        parts.append(fuse(rows[mine], shard))
    for k in range(2):
        torch.testing.assert_close(parts[0][k] + parts[1][k], want[k],
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", list(SPECS))
def test_run_scenario_on_ranks(ranks, name):
    """``run_scenario(spec, mesh=)`` of each tier and async scenario at 2
    rounds or events: both ranks return the same record, rank 0 alone
    writes it, and it is the ``mesh=None`` record but for accuracies
    within one eval example; a tiered run's first global within RTOL of
    one process's."""
    a, b = ranks["spec"][name]
    assert a["record"] == b["record"]
    one = ranks["one_spec"][name]
    ra, ro = a["record"], one["record"]
    assert ra["rounds"] == [0, 1]
    assert {k: v for k, v in ra.items() if "acc" not in k} == \
        {k: v for k, v in ro.items() if "acc" not in k}
    np.testing.assert_allclose(ra["acc"], ro["acc"],
                               atol=1 / SMALL["test_size"] + 1e-9)
    if ra["mode"] == "async":
        assert a["globals"] == []         # no sync round ran
    else:
        assert len(a["globals"]) == SMALL["rounds"]
        rp.within(rp.ref_tree(a["globals"][0]),
                  rp.ref_tree(one["globals"][0]))
    path = f"scenario_{name}.json"
    assert not os.path.exists(os.path.join(ranks["out"], "rank1", path))
    with open(os.path.join(ranks["out"], "rank0", path)) as f:
        assert json.load(f)["acc"] == ra["acc"]
    c = a["collectives"]["calls"]
    assert c == {"all_reduce": SPECS[name] * SMALL["rounds"],
                 "all_to_all": 0, "all_gather": 0}


def test_one_process_async_keeps_its_buffer_and_kernel():
    """In one process the event rows are the whole buffer and the
    fusion keeps its kernel route; on a rank, the kernel is off and a
    rank's rows fill the front of its buffer."""
    from repro_torch.fl import async_engine
    from repro_torch.fl.runtime import FLConfig, cnn_task
    from repro_torch.configs import vgg9
    task = cnn_task(vgg9.reduced())
    fl = FLConfig(population=5, cohort_size=4, mode="async", buffer_k=3)
    params = task.init_fn(torch.Generator())
    one = async_engine.make_async_engine(task, fl, params, device="cpu")
    assert one.engine.ctx.use_kernel and one.mesh is None
    assert one.slot_owner.tolist() == [0, 0, 0, 0]
    rank = async_engine.make_async_engine(task, fl, params, device="cpu",
                                          mesh=_mesh(1))
    assert not rank.engine.ctx.use_kernel
    assert rank.engine.rows == slice(2, 4)
    assert rank.slot_owner.tolist() == [0, 0, 1, 1]
    assert rank.buffer.shape == (3, rank.layout.size)
