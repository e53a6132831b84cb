"""The port's auto-depth workflow (``repro_torch.launch.auto_depth``)
against the same steps composed from the reference's functions.

Tolerances: the same TV profile (1e-4 relative) and chosen depth,
accuracies within one eval example, and final parameters within 1e-4
or, if larger, twice what a one-ulp change of the initial parameters
does to the port's own run. After one round the port and the reference
agree to 1.2e-7; the second round's 8 local steps amplify round-off of
any origin to about 1.2e-4 (measured: port vs reference 1.22e-4, port vs
port from an init moved by one ulp 1.21e-4), so a fixed 1e-4 would test
this run's conditioning, not the port.

Torch runs on one intra-op thread here (``_one_thread``), as in
tests/test_torch_eq9_kernel_route.py.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import vgg9 as jvgg9
from repro.core import feature_stats as jfs
from repro.core import grouping as jgrouping
from repro.data import synthetic as jdata
from repro.fl import runtime as jruntime
from repro.models import cnn as jcnn
from repro.optim.optimizers import sgd as jsgd
from repro_torch import convert
from repro_torch.kernels import feature_stats as kfs
from repro_torch.kernels import paired_fusion as pf
from repro_torch.launch import auto_depth
from repro_torch.models.module import tree_leaves, tree_map

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cfg(tcfg):
    """The reference's CNNConfig with the port config's fields."""
    return jcnn.CNNConfig(**{f.name: getattr(tcfg, f.name)
                             for f in dataclasses.fields(tcfg)
                             if f.name != "dtype"})


def _jax_init_np(jcfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jcnn.init_cnn(jax.random.PRNGKey(seed), jcfg))


AUTO_WARMUP, AUTO_ROUNDS = 6, 2


@functools.lru_cache(maxsize=None)
def _reference_auto_depth():
    """examples/auto_depth_fed2.py's steps, composed from the reference's
    functions, with AUTO_WARMUP warm-up steps and AUTO_ROUNDS rounds."""
    A = auto_depth
    ds = jdata.make_image_dataset(A.TRAIN_SIZE, n_classes=10, seed=0,
                                  noise=A.NOISE)
    test = jdata.make_image_dataset(A.TEST_SIZE, n_classes=10, seed=99,
                                    noise=A.NOISE)
    base = jvgg9.reduced(fed2_groups=0, norm="none")
    p = jcnn.init_cnn(jax.random.PRNGKey(0), base)
    opt = jsgd(A.WARMUP_LR, 0.9)
    st = opt.init(p)

    @jax.jit
    def step(p, st, b):
        return opt.update(jax.grad(jcnn.cnn_loss)(p, base, b), st, p, 0)

    rng = np.random.default_rng(0)
    for _ in range(AUTO_WARMUP):
        sel = rng.integers(0, len(ds.labels), A.WARMUP_BATCH)
        p, st = step(p, st, {"images": jnp.asarray(ds.images[sel]),
                             "labels": jnp.asarray(ds.labels[sel])})
    pv = jfs.class_preference_vectors(
        p, base, jnp.asarray(ds.images[:A.PROBE_IMAGES]),
        jnp.asarray(ds.labels[:A.PROBE_IMAGES]), use_kernel=True)
    tvs = [float(jfs.total_variance(v)) for v in pv]
    depth = max(jgrouping.choose_decouple_depth(tvs, threshold_frac=0.5,
                                                min_shared=2), 1)
    cfg = jvgg9.reduced(fed2_groups=A.GROUPS, decouple=depth, norm="gn")
    parts = jdata.nxc_partition(ds.labels, A.CLIENTS, A.CLASSES_PER_NODE,
                                10, seed=1)
    fl = jruntime.FLConfig(population=A.CLIENTS, rounds=AUTO_ROUNDS,
                           local_epochs=1, steps_per_epoch=A.STEPS,
                           batch_size=A.BATCH, lr=A.LR, momentum=0.9,
                           method="fed2")
    h = jruntime.run_federated(
        jruntime.cnn_task(cfg), fl, parts,
        lambda s: {"images": jnp.asarray(ds.images[s]),
                   "labels": jnp.asarray(ds.labels[s])},
        [{"images": jnp.asarray(test.images),
          "labels": jnp.asarray(test.labels)}], mesh=None,
        use_kernel=False)
    return tvs, depth, h


def test_auto_depth_matches_reference_workflow():
    tvs_j, depth_j, hj = _reference_auto_depth()

    def init_params(tcfg):       # the reference's PRNGKey(0) inits
        return convert.to_port(_jax_init_np(_jax_cfg(tcfg)))

    def init_ulp(tcfg):          # the same, moved up by one ulp
        return tree_map(lambda t: torch.nextafter(
            t, torch.full_like(t, np.inf)), init_params(tcfg))

    def run(init):
        return auto_depth.run_auto_depth(
            reduced=True, device="cpu", init_params=init,
            warmup_steps=AUTO_WARMUP, rounds=AUTO_ROUNDS)

    before = (kfs.feature_stats.launches, pf.paired_fusion.launches)
    out = run(init_params)
    assert (kfs.feature_stats.launches, pf.paired_fusion.launches) == before
    ulp = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(out["history"]["final_params"]),
        tree_leaves(run(init_ulp)["history"]["final_params"])))
    limit = max(TOL, 2 * ulp)
    np.testing.assert_allclose(out["tvs"], tvs_j, rtol=1e-4)
    assert out["depth"] == depth_j
    assert out["cfg"].decouple == depth_j
    h = out["history"]
    np.testing.assert_allclose(h["acc"], hj["acc"], atol=1.0 / 400 + 1e-9)
    got = convert.to_reference(h["final_params"])
    want = jax.tree_util.tree_map(np.asarray, hj["final_params"])
    fg = jax.tree_util.tree_leaves(got)
    fw = jax.tree_util.tree_leaves(want)
    assert len(fg) == len(fw)
    for a, b in zip(fg, fw):
        np.testing.assert_allclose(a, b, atol=limit)
    assert all(t.device.type == "cpu" for t in tree_leaves(h["final_params"]))
