"""The port's capacity tiers (``repro_torch.fl.capacity``) against the
reference's (``repro.fl.capacity``), on the same numpy-seeded inputs.

- ``parse_tiers`` / ``validate_mix`` / ``TierPlan.assignment`` equal,
  and every refusal carries the reference's message;
- every ``LeafSlice`` (indices with conv weights in the port's OIHW
  order, tier shape, group geometry) equals the reference's, the
  conv->fc flatten rows and the K = 1 squeeze included, and so do the
  tier configs and parameter counts, at the reduced widths and at the
  full VGG9 widths the card runs;
- the masked loss of a grouped tier equals the reference's (1e-6);
- ``extract`` and the overlap-aware combine equal the reference's on
  random trees, with presence weighting and an uncovered region (1e-6);
- one tiered round of fedavg, fed2 and presence-weighted fed2 equals
  the reference's within 1e-5 or, if larger, twice what a one-ulp
  change of the initial parameters does to the port's own round (the
  rule tests/test_torch_methods.py applies to scaffold): the fed2
  round's 0.6 tier trains on batches almost all of whose labels its
  masked loss drops, and there a one-ulp init change moves the port's
  first conv by 3.1e-5, exactly as far as the port is from the
  reference. A 2-round tiered run under a cohort sampler (zero-weight
  padded tiles) agrees within ``PARAM_TOL`` 1e-4: the tolerances of the
  port's other run comparisons, fp32 on both sides with another
  summation order in convolutions and fusion;
- a single width-1.0 tier is the homogeneous run to the bit, and the
  forced one-tier engine matches the homogeneous round within the
  reference's 2e-6; a region no sampled client holds keeps the
  previous global to the bit;
- scaffold and fedma, and the G = 8 widths the JAX CLI's default
  refuses, refuse with the reference's messages.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import vgg9 as jvgg9
from repro.fl import capacity as jcap
from repro.fl import runtime as jruntime
from repro.fl import scenarios as jscen
from repro_torch import convert
from repro_torch.configs import vgg9 as tvgg9
from repro_torch.fl import capacity as tcap
from repro_torch.fl import methods as tmethods
from repro_torch.fl import runtime as truntime
from repro_torch.fl import scenarios as tscen
from repro_torch.fl.population import Population
from repro_torch.models.module import tree_leaves

PARAM_TOL = 1e-4
ROUND_TOL = 1e-5
SMALL = dict(rounds=1, train_size=240, test_size=80, steps_per_epoch=2,
             batch_size=8)


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


# model configs by name: (port, reference)
CFGS = {
    "grouped": (tvgg9.reduced(), jvgg9.reduced()),            # G=5
    "plain": (tvgg9.reduced(fed2_groups=0, norm="none"),
              jvgg9.reduced(fed2_groups=0, norm="none")),
    "full-g5": (tvgg9.full(fed2_groups=5), jvgg9.full(fed2_groups=5)),
    "baseline": (tvgg9.baseline(), jvgg9.baseline()),
}


# ---------------------------------------------------------------------------
# Tier plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "1.0x2,0.5x2,0.25x2", "0.25x1, 1.0x3,", [(0.5, 2), (1.0, 4)],
    ((1.0, 2), (0.6, 2), (0.2, 2)), "1.0:2", "1.0x2,0.5", "axb"])
def test_parse_tiers_matches_reference(spec):
    got = _message(tcap.parse_tiers, spec)
    assert got == _message(jcap.parse_tiers, spec)
    if got is None:
        assert tcap.parse_tiers(spec) == jcap.parse_tiers(spec)


@pytest.mark.parametrize("mix,population", [
    (((1.0, 2), (0.5, 2), (0.25, 2)), 6), ((), 3), (((0.5, 4),), 4),
    (((1.0, 2), (0.5, 2)), 6), (((1.0, 2), (1.0, 2)), 4),
    (((1.5, 4),), 4), (((1.0, 0),), 0), (((1.0, 2), (0.0, 2)), 4)])
def test_validate_mix_matches_reference(mix, population):
    assert (_message(tcap.validate_mix, mix, population)
            == _message(jcap.validate_mix, mix, population))


@pytest.mark.parametrize("mix,population,seed", [
    ("1.0x2,0.5x2,0.25x2", 6, 0), ("1.0x2,0.5x3,0.25x1", 6, 3),
    ("1.0x4,0.6x3,0.2x3", 10, 11), ("1.0x3", 3, 0)])
def test_tier_plan_matches_reference(mix, population, seed):
    t = tcap.TierPlan.from_mix(mix, population, seed=seed)
    j = jcap.TierPlan.from_mix(mix, population, seed=seed)
    assert t.mix == j.mix and t.trivial == j.trivial
    np.testing.assert_array_equal(t.assignment, j.assignment)
    assert t.assignment.dtype == j.assignment.dtype
    assert [x.name for x in t.tiers] == [x.name for x in j.tiers]
    ids = np.array([5, 1, 3, 0]) % population
    for k in range(len(t.mix)):
        np.testing.assert_array_equal(t.ids_of(k), j.ids_of(k))
        np.testing.assert_array_equal(t.ids_of(k, ids), j.ids_of(k, ids))


# ---------------------------------------------------------------------------
# Sub-models: configs, slices, masked loss
# ---------------------------------------------------------------------------


def _port_order(leaf):
    """A reference LeafSlice's axes in the port's layout: a 4-D leaf is a
    conv weight, HWIO there and OIHW here."""
    if len(leaf.idx) != 4:
        return leaf.idx, leaf.shape, leaf.group_axis
    perm = (3, 2, 0, 1)
    ga = None if leaf.group_axis is None else perm.index(leaf.group_axis)
    return (tuple(leaf.idx[a] for a in perm),
            tuple(leaf.shape[a] for a in perm), ga)


@pytest.mark.parametrize("cfg,width", [
    ("grouped", 1.0), ("grouped", 0.8), ("grouped", 0.6), ("grouped", 0.4),
    ("grouped", 0.2), ("plain", 1.0), ("plain", 0.5), ("plain", 0.25),
    ("full-g5", 0.6), ("full-g5", 0.2), ("baseline", 0.5),
    ("baseline", 0.25)])
def test_tier_model_matches_reference(cfg, width):
    tcfg, jcfg = CFGS[cfg]
    t, j = tcap.cnn_tier_model(tcfg, width), jcap.cnn_tier_model(jcfg,
                                                                 width)
    for f in ("arch_id", "plan", "fc_dims", "n_classes", "fed2_groups",
              "decouple", "norm"):
        assert getattr(t.model_cfg, f) == getattr(j.model_cfg, f), f
    assert (t.param_bytes, t.n_classes_kept) == (j.param_bytes,
                                                 j.n_classes_kept)
    tl = tree_leaves(t.slices)
    jl = jax.tree_util.tree_leaves(
        j.slices, is_leaf=lambda x: isinstance(x, jcap.LeafSlice))
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        idx, shape, ga = _port_order(b)
        assert a.shape == shape and a.group_axis == ga
        assert (a.block, a.kept, a.tier_grouped) == (b.block, b.kept,
                                                     b.tier_grouped)
        assert len(a.idx) == len(idx)
        for x, y in zip(a.idx, idx):
            np.testing.assert_array_equal(x, y)


def test_flatten_rows_and_k1_squeeze_are_carried_over():
    plain = tcap.cnn_tier_model(CFGS["plain"][0], 0.5)
    rows = plain.slices["fcs"][0]["w"].idx[0]
    c_full, c_tier = 40, 20           # vgg9.reduced's last conv
    np.testing.assert_array_equal(rows, np.nonzero(
        (np.arange(2 * len(rows)) % c_full) < c_tier)[0])
    k1 = tcap.cnn_tier_model(CFGS["grouped"][0], 0.2)
    assert k1.model_cfg.fed2_groups == 1
    s = k1.slices["fcs"][-1]["w"]
    assert len(s.sliced_shape) == len(s.shape) + 1 and s.sliced_shape[0] == 1


@pytest.mark.parametrize("width,labels", [
    (0.6, [0, 1, 2, 3]), (0.6, [0, 1, 2, 9]), (0.6, [7, 8, 9, 9]),
    (0.2, [0, 1, 5, 1])])
def test_masked_loss_matches_reference(width, labels):
    tcfg, jcfg = CFGS["grouped"]
    jfull = jruntime.cnn_task(jcfg).init_fn(jax.random.PRNGKey(0))
    jm, tm = jcap.cnn_tier_model(jcfg, width), tcap.cnn_tier_model(tcfg,
                                                                  width)
    jp = jcap.extract_params(jfull, jm.slices)
    tp = convert.to_port(jax.tree_util.tree_map(np.asarray, jp))
    x = np.random.default_rng(0).normal(size=(4, 32, 32, 3)).astype(
        np.float32)
    y = np.asarray(labels, np.int32)
    want = float(jm.task.loss_fn(jp, {"images": jnp.asarray(x),
                                      "labels": jnp.asarray(y)}))
    got = float(tm.task.loss_fn(tp, {"images": torch.as_tensor(x),
                                     "labels": torch.as_tensor(y)}))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (got, want)


# ---------------------------------------------------------------------------
# extract and combine on random trees
# ---------------------------------------------------------------------------


def _random_tree(jcfg, seed):
    shapes = jax.eval_shape(jruntime.cnn_task(jcfg).init_fn,
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("cfg,width", [("grouped", 0.6), ("grouped", 0.2),
                                       ("plain", 0.5), ("plain", 0.25)])
def test_extract_matches_reference(cfg, width):
    tcfg, jcfg = CFGS[cfg]
    tree = _random_tree(jcfg, 1)
    want = jcap.extract_params(tree, jcap.cnn_tier_model(jcfg, width).slices)
    tm = tcap.cnn_tier_model(tcfg, width)
    got = tcap.extract_params(convert.to_port(tree), tm.slices)
    for a, b in zip(tree_leaves(convert.to_port(want)), tree_leaves(got)):
        assert torch.equal(a, b)
    # the flat route: one index_select over the full vector
    task = truntime.cnn_task(tcfg)
    params = convert.to_port(tree)
    plan = tcap.TierPlan.from_mix(((1.0, 1), (width, 1)), 2)
    eng = tcap.make_tiered_engine(
        task, truntime.FLConfig(population=2, method="fedavg",
                                tiers=plan.mix), params, plan,
        device="cpu", method=tmethods.get("fedavg"))
    tile = eng.tiles[1]
    flat = tile.extract(eng.full.layout.flatten(params))
    assert torch.equal(flat, tile.engine.layout.flatten(got))


COMBINE = {
    "fedavg": ("plain", ((1.0, 2), (0.5, 2), (0.25, 2)), False),
    "fed2": ("grouped", ((1.0, 2), (0.6, 2), (0.2, 2)), False),
    "fed2-presence": ("grouped", ((1.0, 2), (0.6, 2), (0.2, 2)), True),
}


@pytest.mark.parametrize("absent", [None, 0, 2])
@pytest.mark.parametrize("case", sorted(COMBINE))
def test_combine_matches_reference(case, absent):
    """Random tier means, weight masses and presence column masses
    through both combines; ``absent`` names a tier no sampled client
    holds (mass 0: its region keeps the previous global when it is the
    full tier)."""
    cfg, mix, use_gw = COMBINE[case]
    method = "fed2" if cfg == "grouped" else "fedavg"
    tcfg, jcfg = CFGS[cfg]
    glob = _random_tree(jcfg, 2)
    plan = tcap.TierPlan.from_mix(mix, 6)
    jeng = jcap.make_tiered_engine(
        jruntime.cnn_task(jcfg), jruntime.FLConfig(
            population=6, method=method, tiers=mix),
        glob, jcap.TierPlan.from_mix(mix, 6), use_gw=use_gw)
    teng = tcap.make_tiered_engine(
        truntime.cnn_task(tcfg), truntime.FLConfig(
            population=6, method=method, tiers=mix),
        convert.to_port(glob), plan, device="cpu", use_gw=use_gw)
    rng = np.random.default_rng(3)
    jmeans, tmeans, wm, gm = [], [], [], []
    for t, (tile_j, tile_t) in enumerate(zip(jeng.tiles, teng.tiles)):
        shapes = jax.eval_shape(tile_j.model.task.init_fn,
                                jax.random.PRNGKey(0))
        mean = jax.tree_util.tree_map(
            lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
        kept = tile_t.kept
        g = rng.uniform(0.0, 3.0, size=kept)
        w = float(rng.uniform(1.0, 4.0))
        if t == absent:
            mean = jax.tree_util.tree_map(np.zeros_like, mean)
            w, g = 0.0, np.zeros(kept)
        g[0] = 0.0 if use_gw and kept > 1 and t != absent else g[0]
        jmeans.append(mean)
        tmeans.append(None if t == absent else tile_t.engine.layout.flatten(
            convert.to_port(mean)))
        wm.append(w)
        gm.append(g)
    want = jeng.combine_fn(glob, tuple(jmeans),
                           tuple(np.float32(w) for w in wm),
                           tuple(np.asarray(g, np.float32) for g in gm))
    got = teng.combine(teng.full.layout.flatten(convert.to_port(glob)),
                       tmeans, wm, gm if use_gw else [None] * len(gm))
    want = teng.full.layout.flatten(convert.to_port(
        jax.tree_util.tree_map(np.asarray, want)))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    if absent == 0:     # what only the full tier holds keeps the global
        full = teng.full.layout.flatten(convert.to_port(glob))
        covered = torch.zeros_like(full, dtype=torch.bool)
        for tile in teng.tiles[1:]:
            covered[tile.index] = True
        assert torch.equal(got[~covered], full[~covered])


def test_index_vectors_hold_no_duplicate():
    for cfg, mix in (("grouped", ((1.0, 2), (0.6, 2), (0.2, 2))),
                     ("plain", ((1.0, 2), (0.5, 2), (0.25, 2)))):
        tcfg, _ = CFGS[cfg]
        task = truntime.cnn_task(tcfg)
        params = task.init_fn(torch.Generator().manual_seed(0))
        eng = tcap.make_tiered_engine(
            task, truntime.FLConfig(population=6, method="fedavg",
                                    tiers=mix), params,
            tcap.TierPlan.from_mix(mix, 6), device="cpu",
            method=tmethods.get("fedavg"))
        assert eng.tiles[0].index is None        # the width-1.0 tier
        for tile in eng.tiles[1:]:
            idx = tile.index.numpy()
            assert len(np.unique(idx)) == len(idx) == tile.engine.layout.size
            assert idx.max() < eng.full.layout.size


# ---------------------------------------------------------------------------
# Tiered runs against the reference
# ---------------------------------------------------------------------------


def _inputs(name, presence, **over):
    spec = tscen.get(name).override(**{**SMALL, **over})
    ds, test = spec.datasets()
    parts = spec.partition(ds.labels)
    counts = (np.stack([np.bincount(ds.labels[p], minlength=10)
                        for p in parts]) if presence else None)
    return spec, ds, test, parts, counts


@functools.lru_cache(maxsize=None)
def _reference_run(name, presence, over=()):
    over = dict(over)
    jspec = jscen.get(name).override(**{**SMALL, **over})
    _, ds, test, parts, counts = _inputs(name, presence, **over)
    jtask = jruntime.cnn_task(jspec.model_config())
    init = jax.tree_util.tree_map(
        np.asarray, jtask.init_fn(jax.random.PRNGKey(jspec.seed)))
    kw = ({"class_counts": counts, "group_spec": jspec.group_spec()}
          if presence else {})
    hj = jruntime.run_federated(
        jtask, jspec.fl_config(), parts,
        lambda s: {"images": jnp.asarray(ds.images[s]),
                   "labels": jnp.asarray(ds.labels[s])},
        [{"images": test.images, "labels": test.labels}], mesh=None,
        use_kernel=False, **kw)
    return hj, init


def _port_run(name, presence, init, over=(), **kw):
    tspec, ds, test, parts, counts = _inputs(name, presence, **dict(over))
    tkw = ({"class_counts": counts, "group_spec": tspec.group_spec()}
           if presence else {})
    return truntime.run_federated(
        truntime.cnn_task(tspec.model_config()), tspec.fl_config(), parts,
        lambda s: {"images": ds.images[s], "labels": ds.labels[s]},
        [{"images": test.images, "labels": test.labels}], device="cpu",
        init_params=convert.to_port(init), **tkw, **kw)


def _max_diff(ht, hj):
    got = jax.tree_util.tree_leaves(convert.to_reference(
        ht["final_params"]))
    want = jax.tree_util.tree_leaves(hj["final_params"])
    assert len(got) == len(want)
    assert all(a.shape == np.shape(b) for a, b in zip(got, want))
    return max(float(np.abs(a - np.asarray(b)).max())
               for a, b in zip(got, want))


def _assert_params_close(ht, hj, atol):
    d = _max_diff(ht, hj)
    assert d <= atol, (d, atol)


@pytest.mark.parametrize("name,presence", [
    ("nxc2_fedavg_tiers", False), ("nxc2_fed2_tiers", False),
    ("nxc2_fed2_tiers", True)], ids=["fedavg", "fed2", "fed2-presence"])
def test_tiered_round_matches_reference(name, presence):
    hj, init = _reference_run(name, presence)
    ht = _port_run(name, presence, init)
    ulp = jax.tree_util.tree_map(
        lambda a: np.nextafter(a, np.float32(np.inf)), init)
    sensitivity = _max_diff(ht, {"final_params": convert.to_reference(
        _port_run(name, presence, ulp)["final_params"])})
    _assert_params_close(ht, hj, max(ROUND_TOL, 2 * sensitivity))
    np.testing.assert_allclose(ht["acc"], hj["acc"],
                               atol=1 / SMALL["test_size"] + 1e-9)


def test_tiered_run_under_a_cohort_sampler_matches_reference():
    """Two rounds of uniform sampling at cohort 4 of 6: tiers go short
    or empty and their tiles pad at zero weight."""
    over = (("rounds", 2), ("cohort_size", 4), ("sampler", "uniform"))
    hj, init = _reference_run("dir05_fed2_tiers", False, over)
    ht = _port_run("dir05_fed2_tiers", False, init, over,
                   use_local_kernel=True)
    for a, b in zip(ht["participants"], hj["participants"]):
        np.testing.assert_array_equal(a, np.asarray(b))
    _assert_params_close(ht, hj, PARAM_TOL)


# ---------------------------------------------------------------------------
# Degenerate and forced one-tier paths, uncovered regions
# ---------------------------------------------------------------------------


def _fl(method, population=3, rounds=2, **kw):
    return truntime.FLConfig(population=population, rounds=rounds,
                             local_epochs=1, steps_per_epoch=2,
                             batch_size=8, lr=0.02, momentum=0.9,
                             method=method, seed=0, **kw)


@functools.lru_cache(maxsize=None)
def _data():
    from repro_torch.data import synthetic as tdata
    ds = tdata.make_image_dataset(240, n_classes=10, seed=0, noise=0.8)
    test = tdata.make_image_dataset(80, n_classes=10, seed=9, noise=0.8)
    return ds, test


def _get_batch(sel):
    ds, _ = _data()
    return {"images": ds.images[sel], "labels": ds.labels[sel]}


def _tests():
    _, test = _data()
    return [{"images": test.images, "labels": test.labels}]


def _parts(n):
    from repro_torch.data import synthetic as tdata
    return tdata.nxc_partition(_data()[0].labels, n, 5, 10, seed=0)


@pytest.mark.parametrize("method", tmethods.available())
def test_single_full_width_tier_bit_identical(method):
    grouped = tmethods.get(method).uses_groups
    base = (tvgg9.reduced(n_classes=10, fed2_groups=2, decouple=1,
                          norm="gn") if grouped else CFGS["plain"][0])
    runs = [truntime.run_federated(truntime.cnn_task(base),
                                   _fl(method, **kw), _parts(3),
                                   _get_batch, _tests(), device="cpu")
            for kw in ({"tiers": "1.0x3"}, {})]
    assert runs[0]["acc"] == runs[1]["acc"]
    for a, b in zip(tree_leaves(runs[0]["final_params"]),
                    tree_leaves(runs[1]["final_params"])):
        assert torch.equal(a, b)


def _forced(mix, ids, population=4):
    """One round of the tiered engine over ``ids`` from a seeded init:
    (task, cfg, params, population, global before, global after, the
    tiered engine)."""
    task = truntime.cnn_task(CFGS["plain"][0])
    fl = _fl("fedavg", population=population, rounds=1)
    params = task.init_fn(torch.Generator().manual_seed(0))
    meth = tmethods.get("fedavg")
    plan = tcap.TierPlan.from_mix(mix, population, seed=0)
    tiered = tcap.make_tiered_engine(task, fl, params, plan, device="cpu",
                                     method=meth)
    pop = Population.from_parts(_parts(population))
    pop.tiers = plan.assignment
    gp = tiered.full.layout.flatten(params)
    _, g_t = tcap.run_tiered_round(
        tiered, pop, meth, tiered.full.init_server_state(gp), gp, ids,
        _get_batch, 2, fl, np.random.default_rng(0))
    return task, fl, params, pop, gp, g_t, tiered


def test_forced_tiered_engine_matches_homogeneous_round():
    """The tiered machinery itself (no degenerate shortcut) with one
    width-1.0 tier: the combine at full coverage is the plain weighted
    mean, within the reference's 2e-6."""
    from repro_torch.fl.engine import make_round_engine
    from repro_torch.fl.runtime import _pack_client_batches, device_batches
    task, fl, params, pop, gp, g_t, _ = _forced(((1.0, 4),), np.arange(4))
    engine = make_round_engine(task, fl, params, device="cpu")
    batches = _pack_client_batches(pop.parts, _get_batch, 2, 8,
                                   np.random.default_rng(0))
    state = {"server": engine.init_server_state(gp), "clients": ()}
    _, g_h = engine.run_round(state, gp, device_batches(batches, "cpu"),
                              weights=pop.weights)
    assert (g_t - g_h).abs().max().item() <= 2e-6


def test_uncovered_region_keeps_previous_global():
    """Only half-width clients train: every coordinate outside the half
    tier keeps the previous global to the bit."""
    mix = ((1.0, 2), (0.5, 2))
    half = tcap.TierPlan.from_mix(mix, 4, seed=0).ids_of(1)
    _, _, _, _, gp, g_t, tiered = _forced(mix, half)
    covered = torch.zeros_like(gp, dtype=torch.bool)
    covered[tiered.tiles[1].index] = True
    assert torch.equal(g_t[~covered], gp[~covered])
    assert (g_t[covered] - gp[covered]).abs().max() > 0


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["scaffold", "fedma"])
def test_ineligible_methods_refuse_with_reference_message(method):
    kw = dict(population=6, method=method, tiers="1.0x3,0.5x3")
    got = _message(truntime.FLConfig, **kw)
    assert got is not None and "tier_fusion" in got
    assert got == _message(jruntime.FLConfig, **kw)
    from repro.fl import methods as jmethods
    assert (_message(tcap.check_tier_support, tmethods.get(method))
            == _message(jcap.check_tier_support, jmethods.get(method)))


@pytest.mark.parametrize("kw", [
    dict(tiers="1.0x2,0.5x2"), dict(tiers="1.0x3,0.5x3", attack="sign_flip",
                                    attack_fraction=0.5),
    dict(tiers="1.0x3,0.5x3", robust="trimmed_mean(0.25)"),
    dict(tiers="1.0x3,0.5x3", compute_dtype="bfloat16"),
    dict(tiers="1.0x3,0.5x3", codec="int8"),
    dict(tiers="1.0x3,0.5x3", mode="async"),
    dict(tiers="0.5x6"), dict(tiers="1.0x3;0.5x3")])
def test_tier_config_refusals_match_reference(kw):
    kw = dict(population=6, method="fedavg", **kw)
    got = _message(truntime.FLConfig, **kw)
    assert got is not None and got == _message(jruntime.FLConfig, **kw)


@pytest.mark.parametrize("width", [1.0, 0.6, 0.5, 0.25, 0.3])
def test_tier_widths_refused_at_the_cli_default_groups(width):
    """The JAX CLI's default --fed2-groups 8 refuses every tier of the
    README's example on 10 classes (width*G = 4.8 at 0.6; 8 does not
    divide 10 classes at the others, 1.0 included), and so does the
    port."""
    got = _message(tcap.cnn_tier_config, tvgg9.full(fed2_groups=8), width)
    want = _message(jcap.cnn_tier_config, jvgg9.full(fed2_groups=8), width)
    assert got is not None and got == want


def test_cli_refuses_fed2_tiers_at_the_default_groups():
    """The README's fed2 tier example needs --fed2-groups 5: at the
    CLI's default 8 the full-width tier already refuses (the first tier
    built), with the reference's message."""
    from repro_torch.launch import train
    want = _message(jcap.cnn_tier_config, jvgg9.full(fed2_groups=8), 1.0)
    got = _message(train.main, [
        "--method", "fed2", "--nodes", "6", "--tiers", "1.0x2,0.6x2,0.2x2",
        "--rounds", "1", "--train-size", "80", "--device", "cpu"])
    assert got is not None and got == want
