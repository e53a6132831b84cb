"""The port's IID and quantity-skew partitions against the reference's:
both draw from numpy only, so the shards must be equal to the bit, over
seeds, populations and Dirichlet alphas."""
import numpy as np
import pytest

from repro.data import synthetic as jdata
from repro_torch.data import synthetic as tdata


def _labels(n, seed=3):
    return np.random.default_rng(seed).integers(0, 10, n).astype(np.int32)


def _assert_parts_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,clients", [(120, 4), (1200, 6), (37, 10),
                                       (4000, 100)])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_iid_partition_matches_reference(n, clients, seed):
    labels = _labels(n)
    _assert_parts_equal(tdata.iid_partition(labels, clients, seed=seed),
                        jdata.iid_partition(labels, clients, seed=seed))


@pytest.mark.parametrize("n,clients", [(120, 4), (1200, 6), (4000, 100)])
@pytest.mark.parametrize("alpha", [0.1, 0.5, 5.0])
@pytest.mark.parametrize("seed", [0, 2])
def test_quantity_partition_matches_reference(n, clients, alpha, seed):
    labels = _labels(n)
    got = tdata.quantity_partition(labels, clients, alpha, seed=seed)
    _assert_parts_equal(
        got, jdata.quantity_partition(labels, clients, alpha, seed=seed))
    # every sample lands in exactly one shard
    np.testing.assert_array_equal(np.sort(np.concatenate(got)),
                                  np.arange(n))
