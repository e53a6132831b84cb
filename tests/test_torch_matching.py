"""The port's FedMA matched averaging (``repro_torch.core.matching``)
against the reference's ``repro.core.matching``, on identical stacked
client params (converted: OIHW convs in the port, HWIO in the
reference).

- ``match_permutation`` returns the same permutation at every matchable
  layer of every client. A conv neuron's row lists (I, kh, kw) in the
  port and (kh, kw, I) in the reference, so the float64 costs agree to
  round-off only; the clients below have no near-tie in the assignment.
- ``permute_cnn_neurons`` leaves the port's logits unchanged within
  1e-5 (fp32 sums in another order).
- ``matched_average`` equals the reference's within 1e-6 (the same
  permutations, then one weighted fp32 mean).
- a fedma run (2 rounds, whole cohort and tiled) equals the reference's
  within 1e-4, as the other methods' runs (tests/test_torch_methods.py).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mobilenet as jmobilenet
from repro.configs import vgg9 as jvgg9
from repro.core import matching as jmatch
from repro.fl import runtime as jruntime
from repro.models import cnn as jcnn
from repro_torch import convert
from repro_torch.configs import mobilenet as tmobilenet
from repro_torch.configs import vgg9 as tvgg9
from repro_torch.core import matching as tmatch
from repro_torch.data import synthetic as tdata
from repro_torch.fl import runtime as truntime
from repro_torch.kernels import paired_fusion as pf
from repro_torch.models import cnn as tcnn
from repro_torch.models.module import tree_map


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's xdist workers share the cores
    (see tests/test_torch_eq9_kernel_route.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FAMILIES = {
    "vgg9": (tvgg9.reduced(fed2_groups=0, norm="none"),
             jvgg9.reduced(fed2_groups=0, norm="none")),
    "mobilenet": (tmobilenet.reduced(fed2_groups=0, norm="none"),
                  jmobilenet.reduced(fed2_groups=0, norm="none")),
}


@functools.lru_cache(maxsize=None)
def _clients(name, n=4):
    """n reference clients (numpy): three independent inits and client
    0 with its matchable neurons shuffled and a little noise added, so
    the assignment has a known, non-identity answer."""
    _, jcfg = FAMILIES[name]
    trees = [jax.tree_util.tree_map(
        np.asarray, jcnn.init_cnn(jax.random.PRNGKey(k), jcfg))
        for k in range(n - 1)]
    rng = np.random.default_rng(9)
    moved = trees[0]
    metas = jcnn.layer_meta(jcfg)
    for li in jmatch.matchable_layers(jcfg):
        moved = jmatch.permute_cnn_neurons(
            moved, jcfg, li, rng.permutation(metas[li].c_out))
    moved = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 1e-3 * rng.normal(size=a.shape).astype(
            np.float32), moved)
    return trees + [moved]


def _stack_ref(trees):
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *trees)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_match_permutation_matches_reference(name):
    tcfg, jcfg = FAMILIES[name]
    clients = _clients(name)
    metas = jcnn.layer_meta(jcfg)
    n_convs = sum(1 for m in metas if m.kind in ("c", "dw"))
    layers = tmatch.matchable_layers(tcfg)
    assert layers == jmatch.matchable_layers(jcfg) and layers
    jref, tref = clients[0], convert.to_port(clients[0])
    non_identity = 0
    for c in clients[1:]:
        jcur, tcur = c, convert.to_port(c)
        for li in layers:
            kind = metas[li].kind
            pick = ((lambda p: p["convs"][li]) if kind == "c"
                    else (lambda p: p["fcs"][li - n_convs]))
            want = jmatch.match_permutation(
                jmatch._neuron_matrix(pick(jref), kind),
                jmatch._neuron_matrix(pick(jcur), kind))
            got = tmatch.match_permutation(
                tmatch._neuron_matrix(pick(tref), kind),
                tmatch._neuron_matrix(pick(tcur), kind))
            np.testing.assert_array_equal(got, want, err_msg=f"layer {li}")
            non_identity += int((got != np.arange(len(got))).any())
            jcur = jmatch.permute_cnn_neurons(jcur, jcfg, li, want)
            tcur = tmatch.permute_cnn_neurons(tcur, tcfg, li, got)
        # each package's permuted client is the same tree
        for a, b in zip(jax.tree_util.tree_leaves(convert.to_reference(
                tcur)), jax.tree_util.tree_leaves(jcur)):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert non_identity >= len(layers)   # the shuffled client at least


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_permute_cnn_neurons_keeps_logits(name):
    tcfg, _ = FAMILIES[name]
    p = convert.to_port(_clients(name)[1])
    x = torch.tensor(np.random.default_rng(2).normal(
        size=(6, 32, 32, 3)).astype(np.float32))
    before = tcnn.apply_cnn(p, tcfg, x)
    rng = np.random.default_rng(3)
    metas = tcnn.layer_meta(tcfg)
    q = p
    for li in tmatch.matchable_layers(tcfg):
        q = tmatch.permute_cnn_neurons(q, tcfg, li,
                                       rng.permutation(metas[li].c_out))
    assert any(not torch.equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(q), jax.tree_util.tree_leaves(p)))
    torch.testing.assert_close(tcnn.apply_cnn(q, tcfg, x), before,
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", sorted(FAMILIES))
@pytest.mark.parametrize("weights", [None, (3.0, 1.0, 2.0, 5.0)])
def test_matched_average_matches_reference(name, weights):
    tcfg, jcfg = FAMILIES[name]
    stacked = _stack_ref(_clients(name))
    w = None if weights is None else np.asarray(weights)
    want = jmatch.matched_average(
        jax.tree_util.tree_map(jnp.asarray, stacked), jcfg, w)
    tstacked = tree_map(
        lambda a: torch.as_tensor(a.transpose(0, 4, 3, 1, 2).copy()
                                  if a.ndim == 5 else a),
        stacked)                          # (N, HWIO) -> (N, OIHW)
    got = tmatch.matched_average(tstacked, tcfg, w)
    for a, b in zip(jax.tree_util.tree_leaves(convert.to_reference(got)),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("cohort_size", [None, 2], ids=["whole", "tiled"])
def test_fedma_run_matches_reference(cohort_size):
    tcfg, jcfg = FAMILIES["vgg9"]
    ds = tdata.make_image_dataset(160, n_classes=10, seed=0, noise=0.8)
    test = tdata.make_image_dataset(40, n_classes=10, seed=99, noise=0.8)
    parts = tdata.nxc_partition(ds.labels, 4, 2, 10, seed=0)
    init = _clients("vgg9")[0]
    tests = [{"images": test.images, "labels": test.labels}]
    kw = dict(population=4, cohort_size=cohort_size, rounds=2,
              local_epochs=1, steps_per_epoch=3, batch_size=8, lr=0.015,
              momentum=0.9, method="fedma", seed=0)
    jtask = dataclasses.replace(
        jruntime.cnn_task(jcfg),
        init_fn=lambda k: jax.tree_util.tree_map(jnp.asarray, init))
    hj = jruntime.run_federated(
        jtask, jruntime.FLConfig(**kw), parts,
        lambda s: {"images": jnp.asarray(ds.images[s]),
                   "labels": jnp.asarray(ds.labels[s])}, tests, mesh=None,
        use_kernel=False)
    before = pf.paired_fusion.launches
    ht = truntime.run_federated(
        truntime.cnn_task(tcfg), truntime.FLConfig(**kw), parts,
        lambda s: {"images": ds.images[s], "labels": ds.labels[s]}, tests,
        device="cpu", init_params=convert.to_port(init))
    assert pf.paired_fusion.launches == before
    np.testing.assert_allclose(ht["acc"], hj["acc"], atol=1 / 40 + 1e-9)
    for a, b in zip(jax.tree_util.tree_leaves(convert.to_reference(
            ht["final_params"])), jax.tree_util.tree_leaves(
            hj["final_params"])):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)
