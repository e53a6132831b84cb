"""The port's examples (``repro_torch.examples``) against the reference's
``examples/*.py``, composed from the reference's library calls on the
CPU, as tests/test_torch_auto_depth.py composes auto_depth_fed2.py.
Each port run starts from the reference's initial parameters
(``PRNGKey(0)``, the key its ``run_federated`` and examples draw with),
converted by ``repro_torch.convert``.

Tolerances:
- quickstart: the class map equal; the layer TVs and the fused loss
  within 1e-5 (relative for the TVs): one fp32 SGD step and one fusion;
- fed2_cifar_fl, 2 rounds of fedavg and fed2: accuracy within one eval
  example (1/600), each group's accuracy within one example of its
  group (1/its support): an argmax may flip on a near-tie under fp32
  round-off;
- llm_federated_finetune, 1 round: final parameters within rtol = atol
  = 1e-5, tests/test_torch_lm_fl.py's tolerance for lm_task, and the
  accuracy within one eval position;
- serve_decode, 4 steps of each reduced arch: greedy tokens equal,
  logits within 1e-4 (fp32 decode, 2 layers).

Torch runs on one intra-op thread here (``_one_thread``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import vgg9 as jvgg9
from repro.configs.common import with_fed2 as jwith_fed2
from repro.core import feature_stats as jfs
from repro.core import fusion as jfusion
from repro.core.grouping import GroupSpec as JGroupSpec
from repro.data import synthetic as jdata
from repro.fl import evaluation as jeval
from repro.fl import methods as jmethods
from repro.fl import runtime as jrt
from repro.launch.steps import make_serve_step as jmake_serve_step
from repro.models import cnn as jcnn
from repro.models import transformer as jtfm
from repro.models.forward import init_cache as jinit_cache
from repro_torch import convert
from repro_torch.examples import (fed2_cifar_fl, llm_federated_finetune,
                                  quickstart, serve_decode)
from repro_torch.models.module import tree_leaves

TV_RTOL = LOSS_TOL = 1e-5
LM_TOL = 1e-5
LOGIT_TOL = 1e-4
CIFAR_ROUNDS, LM_ROUNDS, SERVE_STEPS = 2, 1, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cnn_init(jcfg):
    """What the reference's run_federated starts a CNN run from."""
    return _np(jrt.cnn_task(jcfg).init_fn(jax.random.PRNGKey(0)))


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------


def _reference_quickstart():
    """examples/quickstart.py's steps."""
    cfg = jvgg9.reduced(fed2_groups=5, decouple=3, norm="gn")
    spec = JGroupSpec.contiguous(cfg.fed2_groups, cfg.n_classes)
    params = jcnn.init_cnn(jax.random.PRNGKey(0), cfg)
    ds = jdata.make_image_dataset(128, n_classes=10, seed=0)
    images, labels = jnp.asarray(ds.images), jnp.asarray(ds.labels)
    pvecs = jfs.class_preference_vectors(params, cfg, images[:32],
                                         labels[:32])
    tvs = [float(jfs.total_variance(p)) for p in pvecs]
    grad_fn = jax.grad(jcnn.cnn_loss)

    def local_step(p, lo, hi):
        batch = {"images": images[lo:hi], "labels": labels[lo:hi]}
        return jax.tree_util.tree_map(lambda w, g: w - 0.05 * g, p,
                                      grad_fn(p, cfg, batch))

    clients = [local_step(params, 0, 64), local_step(params, 64, 128)]
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *clients)
    fused = jfusion.paired_average(stacked, jfusion.cnn_group_axes(params,
                                                                   cfg))
    loss = jcnn.cnn_loss(fused, cfg, {"images": images[:64],
                                      "labels": labels[:64]})
    return spec.classes_per_group, tvs, float(loss), _np(params)


def test_quickstart_matches_reference():
    from repro_torch.kernels import feature_stats, paired_fusion
    classes, tvs, loss, init = _reference_quickstart()
    before = (feature_stats.feature_stats.launches,
              paired_fusion.paired_fusion.launches)
    out = quickstart.run_quickstart(
        device="cpu", init_params=lambda cfg: convert.to_port(init))
    assert before == (feature_stats.feature_stats.launches,
                      paired_fusion.paired_fusion.launches)
    assert out["classes_per_group"] == classes
    np.testing.assert_allclose(out["tvs"], tvs, rtol=TV_RTOL)
    assert abs(out["loss"] - loss) <= LOSS_TOL


# ---------------------------------------------------------------------------
# fed2_cifar_fl
# ---------------------------------------------------------------------------


def _cifar_cfg(method):
    if jmethods.get(method).uses_groups:
        return jvgg9.reduced(fed2_groups=5, decouple=3, norm="gn")
    return jvgg9.reduced(fed2_groups=0, norm="none")


@functools.lru_cache(maxsize=None)
def _reference_cifar(method):
    """examples/fed2_cifar_fl.py's run of ``method`` at its defaults, for
    CIFAR_ROUNDS rounds, on the plain fusion route (the CPU's)."""
    ds = jdata.make_image_dataset(3000, n_classes=10, seed=0, noise=1.6)
    test = jdata.make_image_dataset(600, n_classes=10, seed=99, noise=1.6)
    parts = jdata.nxc_partition(ds.labels, 6, 5, 10, seed=1)
    fl = jrt.FLConfig(population=6, cohort_size=None, sampler="full",
                      rounds=CIFAR_ROUNDS, local_epochs=1, steps_per_epoch=6,
                      batch_size=16, lr=0.015, momentum=0.9, method=method,
                      seed=0)
    h = jrt.run_federated(
        jrt.cnn_task(_cifar_cfg(method)), fl, parts,
        lambda s: {"images": jnp.asarray(ds.images[s]),
                   "labels": jnp.asarray(ds.labels[s])},
        [{"images": jnp.asarray(test.images),
          "labels": jnp.asarray(test.labels)}], mesh=None, use_kernel=False)
    spec = JGroupSpec.contiguous(5, 10)
    support = np.array([np.isin(test.labels, g).sum()
                        for g in spec.classes_per_group])
    return h, jeval.group_accuracy(h["confusion"][-1], spec), support


@pytest.mark.parametrize("method", ["fedavg", "fed2"])
def test_fed2_cifar_fl_matches_reference(method):
    want, want_groups, support = _reference_cifar(method)
    init = _cnn_init(_cifar_cfg(method))
    got = fed2_cifar_fl.run_fed2_cifar_fl(
        rounds=CIFAR_ROUNDS, methods=method, device="cpu", log=None,
        init_params=lambda cfg: convert.to_port(init))
    assert list(got) == [method]
    np.testing.assert_allclose(got[method]["acc"], want["acc"],
                               atol=1.0 / 600 + 1e-9)
    groups = fed2_cifar_fl.group_accuracies(got)[method]
    assert np.all(np.abs(groups - want_groups) * support <= 1 + 1e-6), \
        (groups, want_groups)


# ---------------------------------------------------------------------------
# llm_federated_finetune
# ---------------------------------------------------------------------------


def _lm_jcfg():
    return jwith_fed2(jget_config("llama3.2-1b", reduced=True), groups=4,
                      decouple=1)


@functools.lru_cache(maxsize=None)
def _reference_lm():
    """examples/llm_federated_finetune.py at its defaults for LM_ROUNDS
    rounds (fedavg and fed2; its init drawn as its run_federated draws
    it, at PRNGKey(0))."""
    cfg, seq, nodes = _lm_jcfg(), 64, 4
    toks, domains = jdata.make_token_dataset(800, seq + 1, cfg.vocab,
                                             n_domains=4, seed=0)
    parts = [np.flatnonzero(domains == j) for j in range(nodes)]

    def get_batch(sel):
        sl = toks[sel]
        return {"tokens": jnp.asarray(sl[:, :-1]),
                "labels": jnp.asarray(sl[:, 1:]),
                "mask": jnp.ones((len(sel), seq), jnp.float32)}

    test_toks, _ = jdata.make_token_dataset(64, seq + 1, cfg.vocab,
                                            n_domains=4, seed=7)
    test_batches = [{"tokens": jnp.asarray(test_toks[:, :-1]),
                     "labels": jnp.asarray(test_toks[:, 1:]),
                     "mask": jnp.ones((64, seq), jnp.float32)}]
    out = {}
    for method in ("fedavg", "fed2"):
        fl = jrt.FLConfig(population=nodes, rounds=LM_ROUNDS,
                          local_epochs=1, steps_per_epoch=4, batch_size=8,
                          lr=0.01, momentum=0.9, method=method, seed=0)
        out[method] = jrt.run_federated(jrt.lm_task(cfg), fl, parts,
                                        get_batch, test_batches)
    return out


def test_llm_federated_finetune_matches_reference():
    want = _reference_lm()
    init = _np(jrt.lm_task(_lm_jcfg()).init_fn(jax.random.PRNGKey(0)))
    logged = []
    got = llm_federated_finetune.run_llm_federated_finetune(
        rounds=LM_ROUNDS, methods="fedavg,fedma,fed2", device="cpu",
        init_params=lambda cfg: convert.lm_to_port(init), log=logged.append)
    assert list(got) == ["fedavg", "fed2"]
    assert logged[1].startswith("fedma: skipped (host matched averaging")
    for method in got:
        h, w = got[method], want[method]
        np.testing.assert_allclose(h["acc"], w["acc"], atol=1.0 / (64 * 64))
        fg = tree_leaves(h["final_params"])
        fw = jax.tree_util.tree_leaves(w["final_params"])
        assert len(fg) == len(fw)
        for a, b in zip(fg, fw):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=LM_TOL, atol=LM_TOL)


# ---------------------------------------------------------------------------
# serve_decode
# ---------------------------------------------------------------------------


def _reference_serve(arch, batch=4, gen=SERVE_STEPS):
    """examples/serve_decode.py's loop for one arch: greedy tokens and
    every step's logits."""
    cfg = jget_config(arch, reduced=True)
    params = jtfm.init_params(jax.random.PRNGKey(0), cfg)
    serve = jax.jit(jmake_serve_step(cfg))
    cache = jinit_cache(cfg, batch, 128)
    tok = jnp.zeros((batch, 1), jnp.int32)
    logits, cache = serve(params, cache, tok, jnp.int32(0))
    steps, toks = [np.asarray(logits[:, 0])], []
    for t in range(1, gen + 1):
        nxt = jnp.argmax(logits[:, 0], axis=-1)[:, None].astype(jnp.int32)
        logits, cache = serve(params, cache, nxt, jnp.int32(t))
        toks.append(np.asarray(nxt[:, 0]))
        steps.append(np.asarray(logits[:, 0]))
    return np.stack(toks, 1), np.stack(steps), _np(params)


@pytest.mark.parametrize("arch", serve_decode.ARCHS.split(","))
def test_serve_decode_matches_reference(arch):
    toks, logits, init = _reference_serve(arch)
    got = serve_decode.run_serve_decode(
        archs=arch, gen=SERVE_STEPS, device="cpu",
        init_params=lambda cfg: convert.lm_to_port(init))[arch]
    np.testing.assert_array_equal(got["tokens"], toks)
    np.testing.assert_allclose(got["logits"], logits, atol=LOGIT_TOL,
                               rtol=0)
