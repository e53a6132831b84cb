"""The port's client samplers and alias table against the reference's.

Each sampler must return the same ids as the reference's over 20 rounds
from one shared-seed rng, and leave that rng in the same state (the
batch-packing stream that follows depends on it). ``AliasTable``'s
``prob`` and ``alias`` must equal the reference's to the bit, and its
error cases raise the same messages."""
import numpy as np
import pytest

from repro.fl import population as jpop
from repro.fl import statestore as jstore
from repro_torch.fl import population as tpop
from repro_torch.fl import statestore as tstore


def _weights(kind, p):
    rng = np.random.default_rng(p)
    w = np.maximum(rng.integers(0, 60, p), 1).astype(np.float64)
    if kind == "zeros":
        w[::3] = 0.0
    elif kind == "uniform":
        w[:] = 1.0
    return w


def test_sampler_registry_matches_reference():
    assert tpop.available() == jpop.available()
    for name in tpop.available():
        t, j = tpop.get(name), jpop.get(name)
        assert (t.summary, t.fusion_weights) == (j.summary, j.fusion_weights)


@pytest.mark.parametrize("name", ["full", "uniform", "weighted",
                                  "round_robin"])
@pytest.mark.parametrize("population,cohort", [(7, 3), (100, 3), (100, 10),
                                               (7, 7)])
@pytest.mark.parametrize("wkind", ["counts", "zeros"])
def test_sampler_ids_match_reference(name, population, cohort, wkind):
    w = _weights(wkind, population)
    ts, js = tpop.get(name), jpop.get(name)
    rt, rj = np.random.default_rng(11), np.random.default_rng(11)
    if name == "weighted" and cohort > np.count_nonzero(w):
        # fewer sampleable clients than slots: the same refusal
        with pytest.raises(ValueError) as want:
            js.sample(0, population, cohort, rj, weights=w)
        with pytest.raises(ValueError, match="cannot sample") as got:
            ts.sample(0, population, cohort, rt, weights=w)
        assert str(got.value) == str(want.value)
        return
    for r in range(20):
        got = ts.sample(r, population, cohort, rt, weights=w)
        want = js.sample(r, population, cohort, rj, weights=w)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        if name == "weighted":
            assert (w[got] > 0).all()
    # the rng stream that packs the batches next is where the
    # reference leaves it
    np.testing.assert_array_equal(rt.integers(0, 2 ** 31, 8),
                                  rj.integers(0, 2 ** 31, 8))


@pytest.mark.parametrize("wkind", ["counts", "zeros", "uniform"])
@pytest.mark.parametrize("p", [1, 7, 100, 1000])
def test_alias_table_matches_reference(wkind, p):
    w = _weights(wkind, p)
    if not w.any():
        w[0] = 1.0
    t, j = tstore.AliasTable(w), jstore.AliasTable(w)
    assert (t.n, t.n_nonzero) == (j.n, j.n_nonzero)
    np.testing.assert_array_equal(t.prob, j.prob)
    np.testing.assert_array_equal(t.alias, j.alias)
    rt, rj = np.random.default_rng(5), np.random.default_rng(5)
    np.testing.assert_array_equal(t.draw(rt, 64), j.draw(rj, 64))
    k = min(3, t.n_nonzero)
    np.testing.assert_array_equal(t.sample_without_replacement(rt, k),
                                  j.sample_without_replacement(rj, k))


def test_alias_table_repins_stranded_zero_weights():
    """Float drift can leave a zero-weight column at prob 1.0; both
    tables re-pin it to prob 0 at the heaviest entry."""
    w = np.array([0.0] + [0.1] * 30 + [1e-17, 0.0, 3.0])
    t, j = tstore.AliasTable(w), jstore.AliasTable(w)
    np.testing.assert_array_equal(t.prob, j.prob)
    np.testing.assert_array_equal(t.alias, j.alias)
    assert (t.prob[w == 0.0] == 0.0).all()


@pytest.mark.parametrize("weights", [
    np.zeros((0,)), np.ones((2, 2)), np.array([1.0, np.nan]),
    np.array([1.0, -1.0]), np.zeros(4)])
def test_alias_table_errors_match_reference(weights):
    with pytest.raises(ValueError) as want:
        jstore.AliasTable(weights)
    with pytest.raises(ValueError) as got:
        tstore.AliasTable(weights)
    assert str(got.value) == str(want.value)


def test_sample_without_replacement_error_matches_reference():
    w = np.array([1.0, 0.0, 2.0, 0.0])
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError) as want:
        jstore.AliasTable(w).sample_without_replacement(rng, 3)
    with pytest.raises(ValueError) as got:
        tstore.AliasTable(w).sample_without_replacement(rng, 3)
    assert str(got.value) == str(want.value)


def test_weighted_sampler_caches_its_table():
    s = tpop.get("weighted")
    w = _weights("counts", 50)
    rng = np.random.default_rng(0)
    s.sample(0, 50, 5, rng, weights=w)
    table = s._table
    s.sample(1, 50, 5, rng, weights=w)
    assert s._table is table               # same weights array: reused
    s.sample(2, 50, 5, rng, weights=w.copy())
    assert s._table is not table           # another array: rebuilt
