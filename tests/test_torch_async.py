"""The port's buffered-async federation (``repro_torch.fl.async_engine``)
against the reference's (``repro.fl.async_engine``), on the same
numpy-seeded inputs.

- ``LatencyTrace`` (its rates and every (client, seq) draw),
  ``effective_weights``, ``sync_round_times`` and the spec parsers
  equal the reference's, refusals word for word;
- the dispatch schedule (participants, staleness, ``sim_time``,
  ``fused_seqs``, local tiles) equals the reference driver's for
  ``buffer_k`` 1, 2 and 4 under ``pareto(1.5)``, and a 4-event run's
  parameters agree within 1e-4 (fp32 on both sides, another summation
  order in convolutions and fusion, as tests/test_torch_runtime.py) or,
  if larger, twice what a one-ulp change of the initial parameters does
  to the port's own run (tests/test_torch_methods.py's rule for
  scaffold): this plain 4-class net at lr 0.02 is ill-conditioned, and
  there a one-ulp init change moves the port's run by 6.1e-4, as far as
  the port is from the reference;
- with an infinite buffer, zero latency and the constant discount the
  async run equals the port's own sync run to the bit, for every
  async-eligible method;
- the buffer bound holds and every update fuses exactly once;
- every arrival's row is its own copy: the next tile overwrites the
  engine's cohort buffer, and an old global a pending dispatch still
  needs is never written in place (shown at ``buffer_k`` < cohort and
  a non-zero latency);
- scaffold, fedma, presence-weighted fed2 and the bad configs refuse
  with the reference's messages.
"""
import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import vgg9 as jvgg9
from repro.fl import async_engine as jasync
from repro.fl import methods as jmethods
from repro.fl import population as jpopulation
from repro.fl import runtime as jruntime
from repro_torch import convert
from repro_torch.configs import vgg9 as tvgg9
from repro_torch.data import synthetic as tdata
from repro_torch.fl import async_engine as tasync
from repro_torch.fl import methods as tmethods
from repro_torch.fl import population as tpopulation
from repro_torch.fl import runtime as truntime
from repro_torch.models.module import tree_leaves

PARAM_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's xdist workers share the cores
    (see tests/test_torch_eq9_kernel_route.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _message(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except ValueError as e:
        return str(e)
    return None


@functools.lru_cache(maxsize=None)
def _data():
    ds = tdata.make_image_dataset(240, n_classes=4, seed=0, noise=0.8)
    test = tdata.make_image_dataset(80, n_classes=4, seed=9, noise=0.8)
    return ds, test, _parts(3)


@functools.lru_cache(maxsize=None)
def _parts(population):
    ds = tdata.make_image_dataset(240, n_classes=4, seed=0, noise=0.8)
    return tdata.nxc_partition(ds.labels, population, 2, 4, seed=1)


def _get_batch(sel):
    ds = _data()[0]
    return {"images": ds.images[sel], "labels": ds.labels[sel]}


def _jget_batch(sel):
    return jax.tree_util.tree_map(jnp.asarray, _get_batch(sel))


def _tests():
    test = _data()[1]
    return [{"images": test.images, "labels": test.labels}]


def _fl(pkg, method, **kw):
    base = dict(population=3, rounds=2, local_epochs=1, steps_per_epoch=2,
                batch_size=8, lr=0.02, momentum=0.9, method=method, seed=0)
    return pkg.FLConfig(**{**base, **kw})


def _cfg(pkg, method):
    vgg9 = tvgg9 if pkg is truntime else jvgg9
    if tmethods.get(method).uses_groups:
        return vgg9.reduced(n_classes=4, fed2_groups=2, decouple=1,
                            norm="gn")
    return vgg9.reduced(n_classes=4, fed2_groups=0, norm="none")


ELIGIBLE = [m for m in tmethods.available()
            if m not in ("scaffold", "fedma")]


# ---------------------------------------------------------------------------
# Traces, weights, parsers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec,population,seed", [
    ("pareto(1.5)", 6, 0), ("pareto(1.5)", 10, 3), ("lognormal(0.5)", 6, 7),
    ("zero", 4, 0)])
def test_latency_trace_matches_reference(spec, population, seed):
    t = tasync.LatencyTrace.make(spec, population=population, seed=seed)
    j = jasync.LatencyTrace.make(spec, population=population, seed=seed)
    np.testing.assert_array_equal(t.rates, j.rates)
    assert t.zero == j.zero
    for c, q in itertools.product(range(population), range(12)):
        assert t.latency(c, q) == j.latency(c, q)
    ids = [np.arange(population)[::2], np.arange(population)]
    assert (tasync.sync_round_times(t, ids)
            == jasync.sync_round_times(j, ids))


@pytest.mark.parametrize("policy", ["constant", "polynomial(0.5)",
                                    "polynomial(0)", "polynomial(2.7)"])
def test_effective_weights_match_reference(policy):
    rng = np.random.default_rng(4)
    w = rng.uniform(0.0, 50.0, size=7)
    s = rng.integers(0, 9, size=7)
    for normalize in (False, True):
        got = tasync.effective_weights(w, s, tasync.parse_staleness(policy),
                                       normalize=normalize)
        want = jasync.effective_weights(w, s, jasync.parse_staleness(policy),
                                        normalize=normalize)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    for args, kw in (((np.zeros(2), [1, 2]), {"normalize": True}),
                     (([1.0], [1, 2]), {})):
        assert (_message(tasync.effective_weights, *args,
                         tasync.parse_staleness(policy), **kw)
                == _message(jasync.effective_weights, *args,
                            jasync.parse_staleness(policy), **kw))


@pytest.mark.parametrize("spec", [
    "constant", "polynomial(0.5)", " polynomial(1) ", "polynomial",
    "polynomial(-2)", "poly(1)", "polynomial(x)", 3])
def test_parse_staleness_matches_reference(spec):
    got = _message(tasync.parse_staleness, spec)
    assert got == _message(jasync.parse_staleness, spec)
    if got is None:
        t, j = tasync.parse_staleness(spec), jasync.parse_staleness(spec)
        assert (t.kind, t.a, t.spec) == (j.kind, j.a, j.spec)
        assert t.discount(3) == j.discount(3)


@pytest.mark.parametrize("spec", [
    "zero", "pareto(1.5)", "lognormal(0.5)", "pareto", "pareto(0)",
    "pareto(x)", "gaussian(1)", "", None])
def test_parse_latency_matches_reference(spec):
    got = _message(tasync.parse_latency, spec)
    assert got == _message(jasync.parse_latency, spec)
    if got is None:
        assert tasync.parse_latency(spec) == jasync.parse_latency(spec)


# ---------------------------------------------------------------------------
# The driver against the reference's
# ---------------------------------------------------------------------------


def _drivers(buffer_k, *, rounds=4, cohort=2, population=3,
             method="fedavg", latency="pareto(1.5)", ulp=False):
    """The reference's and the port's drivers on one config, from the
    reference's init (converted): (reference driver and final global,
    port driver and final global); ``ulp`` adds the port's driver from
    the init moved up by one ulp."""
    kw = dict(mode="async", buffer_k=buffer_k, cohort_size=cohort,
              sampler="uniform", staleness="polynomial(0.5)",
              rounds=rounds, population=population)
    jfl, tfl = _fl(jruntime, method, **kw), _fl(truntime, method, **kw)
    jtask = jruntime.cnn_task(_cfg(jruntime, method))
    init = jax.tree_util.tree_map(
        np.asarray, jtask.init_fn(jax.random.PRNGKey(0)))
    parts = _parts(population)
    up = jax.tree_util.tree_map(
        lambda a: np.nextafter(a, np.float32(np.inf)), init)
    out = []
    for pkg, lib, fl, get_batch, start in (
            (jpopulation, jasync, jfl, _jget_batch, init),
            (tpopulation, tasync, tfl, _get_batch, init),
            (tpopulation, tasync, tfl, _get_batch, up))[:3 if ulp else 2]:
        if lib is jasync:
            gp = jax.tree_util.tree_map(jnp.asarray, start)
            eng = jasync.make_async_engine(jtask, fl, gp, use_kernel=False)
        else:
            task = truntime.cnn_task(_cfg(truntime, method))
            eng = tasync.make_async_engine(task, fl, convert.to_port(start),
                                           device="cpu")
            gp = eng.layout.flatten(convert.to_port(start))
        trace = lib.LatencyTrace.make(latency, population=population,
                                      seed=fl.seed)
        driver = lib.AsyncFederation(
            eng, pkg.Population.from_parts(parts), pkg.get(fl.sampler), fl,
            get_batch, 2, np.random.default_rng(fl.seed), trace,
            lib.parse_staleness(fl.staleness))
        _, final = driver.run(eng.init_server_state(gp), gp)
        out.append((driver, final))
    return out


@pytest.mark.parametrize("buffer_k", [1, 2, 4])
def test_dispatch_schedule_matches_reference(buffer_k):
    """4 of 6 clients in flight (the async scenarios' shape)."""
    (jd, _), (td, _) = _drivers(buffer_k, cohort=4, population=6)
    assert td.fused_seqs == jd.fused_seqs
    assert td.local_tiles == jd.local_tiles
    assert td.seq == jd.seq and td.max_buffer_seen == jd.max_buffer_seen
    assert len(td.events) == len(jd.events) == 4
    for a, b in zip(td.events, jd.events):
        assert a["version"] == b["version"]
        np.testing.assert_array_equal(a["participants"], b["participants"])
        assert a["staleness"] == b["staleness"]
        assert a["sim_time"] == b["sim_time"]


def test_four_event_run_matches_reference():
    (_, jg), (td, tg), (_, ug) = _drivers(2, ulp=True)
    assert any(s for ev in td.events for s in ev["staleness"])  # stale
    layout = td.engine.layout
    want = layout.flatten(convert.to_port(
        jax.tree_util.tree_map(np.asarray, jg)))
    sensitivity = (tg - ug).abs().max().item()
    diff = (tg - want).abs().max().item()
    assert diff <= max(PARAM_TOL, 2 * sensitivity), (diff, sensitivity)


def test_run_async_federated_matches_reference_history():
    kw = dict(mode="async", buffer_k=1, cohort_size=2, sampler="uniform",
              staleness="polynomial(0.5)", rounds=3)
    jtask = jruntime.cnn_task(_cfg(jruntime, "fed2"))
    init = jax.tree_util.tree_map(
        np.asarray, jtask.init_fn(jax.random.PRNGKey(0)))
    hj = jruntime.run_federated(jtask, _fl(jruntime, "fed2", **kw),
                                _data()[2], _jget_batch, _tests(),
                                latency="pareto(1.5)", use_kernel=False)
    ht = truntime.run_federated(
        truntime.cnn_task(_cfg(truntime, "fed2")), _fl(truntime, "fed2", **kw),
        _data()[2], _get_batch, _tests(), latency="pareto(1.5)",
        device="cpu", init_params=convert.to_port(init))
    assert ht["round"] == hj["round"] == [0, 1, 2]
    assert ht["staleness"] == hj["staleness"]
    assert ht["sim_time"] == hj["sim_time"]
    for a, b in zip(ht["participants"], hj["participants"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(ht["acc"], hj["acc"], atol=1 / 80 + 1e-9)
    assert len(ht["confusion"]) == 3


# ---------------------------------------------------------------------------
# The sync anchor, driver invariants, aliasing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ELIGIBLE)
def test_infinite_buffer_is_the_sync_run_to_the_bit(method):
    task = truntime.cnn_task(_cfg(truntime, method))
    runs = [truntime.run_federated(task, _fl(truntime, method, **kw),
                                   _data()[2], _get_batch, _tests(),
                                   device="cpu")
            for kw in ({}, {"mode": "async"})]
    sync, asyn = runs
    for a, b in zip(tree_leaves(sync["final_params"]),
                    tree_leaves(asyn["final_params"])):
        assert torch.equal(a, b)
    assert sync["acc"] == asyn["acc"]
    assert asyn["staleness"] == [[0, 0, 0]] * 2
    assert asyn["sim_time"] == [0.0, 0.0]


def _port_driver(buffer_k, latency="pareto(1.5)", rounds=4, cohort=3,
                 use_local_kernel=False):
    fl = _fl(truntime, "fedavg", mode="async", buffer_k=buffer_k,
             cohort_size=cohort, rounds=rounds)
    task = truntime.cnn_task(_cfg(truntime, "fedavg"))
    params = task.init_fn(torch.Generator().manual_seed(0))
    eng = tasync.make_async_engine(task, fl, params, device="cpu",
                                   use_local_kernel=use_local_kernel)
    driver = tasync.AsyncFederation(
        eng, tpopulation.Population.from_parts(_data()[2]),
        tpopulation.get(fl.sampler), fl, _get_batch, 2,
        np.random.default_rng(fl.seed),
        tasync.LatencyTrace.make(latency, population=3, seed=fl.seed),
        tasync.parse_staleness(fl.staleness))
    return driver, eng, eng.layout.flatten(params)


@pytest.mark.parametrize("buffer_k", [1, 2, 3])
def test_buffer_never_exceeds_bound_and_fuses_exactly_once(buffer_k):
    d, eng, gp = _port_driver(buffer_k)
    d.run(eng.init_server_state(gp), gp)
    assert 0 < d.max_buffer_seen <= buffer_k
    fused = [s for ev in d.fused_seqs for s in ev]
    assert len(fused) == len(set(fused))
    assert all(len(ev) == buffer_k for ev in d.fused_seqs)
    assert len(d.fused_seqs) == 4
    leftover = {x.seq for x in d.pending} | {x.seq for x in d.buffer}
    assert set(fused) | leftover == set(range(d.seq))
    assert not (set(fused) & leftover)


def test_zero_latency_runs_one_tile_per_wave():
    d, eng, gp = _port_driver(3, latency="zero", rounds=3)
    d.run(eng.init_server_state(gp), gp)
    assert d.local_tiles == 3


def test_arrival_rows_and_old_globals_are_not_aliased():
    """buffer_k 1 < cohort 3 under pareto(1.5): dispatch groups of older
    versions train after newer events, and each tile overwrites the
    engine's cohort buffer (the local_step route trains in place in
    it, so a tile's rows ARE that buffer). Every fused row must be the
    row its tile computed, and every tile must start from the global
    of its version, as the events produced it."""
    d, eng, gp = _port_driver(1, rounds=6, use_local_kernel=True)
    tiles, groups, fused_rows, produced = [], [], {}, [gp.clone()]
    local_fn, event_fn = eng.local_fn, eng.event_fn
    compute = d._compute_updates

    def recording_compute(arrivals, global_params):
        # the driver's grouping: one tile per needed version, in order
        for v in sorted({x.version for x in arrivals if x.update is None}):
            groups.append((v, [x.seq for x in sorted(
                (x for x in list(arrivals) + d.pending
                 if x.version == v and x.update is None),
                key=lambda x: x.seq)]))
        return compute(arrivals, global_params)

    def recording_local(g, batches):
        out = local_fn(g, batches)
        assert out.data_ptr() == eng.engine.cohort.data_ptr()
        tiles.append((g.clone(), out.clone()))
        return out

    def recording_event(server, g, rows, w):
        for i, x in enumerate(d.buffer):
            fused_rows[x.seq] = rows[i].clone()
            assert (x.update.untyped_storage().data_ptr()
                    != eng.engine.cohort.untyped_storage().data_ptr())
        server, new = event_fn(server, g, rows, w)
        produced.append(new.clone())
        return server, new

    d._compute_updates = recording_compute
    eng.local_fn, eng.event_fn = recording_local, recording_event
    d.run(eng.init_server_state(gp), gp)
    assert any(s for ev in d.events for s in ev["staleness"])
    assert len(tiles) == len(groups) == d.local_tiles > 1
    row_of = {}
    for (v, seqs), (g, out) in zip(groups, tiles):
        assert torch.equal(g, produced[v]), v
        row_of.update({q: out[i] for i, q in enumerate(seqs)})
    assert fused_rows
    for seq, row in fused_rows.items():
        assert torch.equal(row, row_of[seq]), seq


def test_event_fn_is_permutation_invariant():
    fl = _fl(truntime, "fedavg", mode="async", buffer_k=3, cohort_size=3)
    task = truntime.cnn_task(_cfg(truntime, "fedavg"))
    params = task.init_fn(torch.Generator().manual_seed(0))
    eng = tasync.make_async_engine(task, fl, params, device="cpu")
    gp = eng.layout.flatten(params)
    rows = torch.randn(3, gp.shape[0], generator=torch.Generator()
                       .manual_seed(1))
    w = np.array([0.5, 0.2, 0.3])
    ref = None
    for perm in itertools.permutations(range(3)):
        p = list(perm)
        _, ng = eng.event_fn(eng.init_server_state(gp), gp, rows[p], w[p])
        ref = ng if ref is None else ref
        assert (ng - ref).abs().max().item() <= 1e-6


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["scaffold", "fedma"])
def test_ineligible_methods_refuse_with_reference_message(method):
    got = _message(_fl, truntime, method, mode="async")
    assert got is not None and "async_eligible" in got
    assert got == _message(_fl, jruntime, method, mode="async")
    assert (_message(tasync.check_async_support, tmethods.get(method))
            == _message(jasync.check_async_support, jmethods.get(method)))


def test_presence_weighted_fed2_refuses_with_reference_message():
    counts = np.ones((3, 4))
    from repro.core.grouping import GroupSpec as JSpec
    from repro_torch.core.grouping import GroupSpec as TSpec
    got = _message(
        truntime.run_federated, truntime.cnn_task(_cfg(truntime, "fed2")),
        _fl(truntime, "fed2", mode="async"), _data()[2], _get_batch,
        _tests(), class_counts=counts, group_spec=TSpec.contiguous(2, 4),
        device="cpu")
    want = _message(
        jasync.run_async_federated, jruntime.cnn_task(_cfg(jruntime, "fed2")),
        _fl(jruntime, "fed2", mode="async"), _data()[2], _jget_batch,
        _tests(), class_counts=counts, group_spec=JSpec.contiguous(2, 4))
    assert got is not None and "presence-weighted" in got and got == want


@pytest.mark.parametrize("kw", [
    dict(buffer_k=2), dict(staleness="polynomial(0.5)"),
    dict(mode="async", staleness="polynomial(-1)"),
    dict(mode="async", buffer_k=0), dict(mode="async", buffer_k=True),
    dict(mode="turbo"), dict(mode="async", tiers=((1.0, 3),)),
    dict(mode="async", attack="sign_flip", attack_fraction=1),
    dict(mode="async", robust="coordinate_median"),
    dict(mode="async", compute_dtype="bfloat16"),
    dict(mode="async", codec="int8")])
def test_async_config_refusals_match_reference(kw):
    got = _message(_fl, truntime, "fedavg", **kw)
    assert got is not None and got == _message(_fl, jruntime, "fedavg", **kw)


def test_latency_under_sync_refuses_with_reference_message():
    args = (_data()[2], _get_batch, _tests())
    for lat in ("pareto(1.5)", "pareto(0)"):
        got = _message(truntime.run_federated,
                       truntime.cnn_task(_cfg(truntime, "fedavg")),
                       _fl(truntime, "fedavg"), *args, latency=lat,
                       device="cpu")
        want = _message(jruntime.run_federated,
                        jruntime.cnn_task(_cfg(jruntime, "fedavg")),
                        _fl(jruntime, "fedavg"), _data()[2], _jget_batch,
                        _tests(), latency=lat)
        assert got is not None and got == want


def test_buffer_k_defaults_to_the_cohort():
    t = _fl(truntime, "fedavg", mode="async", cohort_size=2)
    j = _fl(jruntime, "fedavg", mode="async", cohort_size=2)
    assert t.buffer_k == j.buffer_k == 2
    assert dataclasses.replace(t, buffer_k=1).buffer_k == 1
