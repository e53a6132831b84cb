"""LM federation in the port (``fl.runtime.lm_task``, ``core.fusion.
lm_group_axes``, ``fl.evaluation``'s counts mode) against the JAX
package, on the CPU, from the same numpy inputs and the same weights
(the reference's ``init_params``, converted by ``convert.lm_to_port``).

Tolerances: the eval counts are sums of 0/1 products of small integers
in fp32, exact in any order: equal. Two rounds of ``run_federated`` on
the reduced Fed2 Mamba-2 (4 clients, one token domain each, 2 local
momentum-SGD steps): final params within rtol = atol = 1e-5 (fp32
gradients summed in other orders, through 2 x 2 SGD steps and two
fusions), next-token accuracy per round equal to the reference's
within one position of the eval set (an argmax may flip on a near-tie
under that round-off). The kernel routes (``use_local_kernel``, the
fusion kernel) take their plain versions on CPU tensors: within 1e-6 of
the plain routes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.common import with_fed2 as jax_with_fed2
from repro.core import fusion as jfusion
from repro.data.synthetic import make_token_dataset
from repro.fl import evaluation as jeval
from repro.fl import runtime as jrt
from repro.models import transformer as jtfm
from repro_torch.configs import get_config
from repro_torch.configs.common import with_fed2
from repro_torch.convert import lm_to_port
from repro_torch.core import fusion
from repro_torch.fl import capacity, evaluation, methods
from repro_torch.fl import runtime as rt
from repro_torch.fl.engine import make_round_engine
from repro_torch.models.module import (FlatLayout, key_path, tree_leaves,
                                       tree_paths)

ARCH = "mamba2-1.3b"
SEQ, N_CLIENTS, STEPS, BATCH = 16, 4, 2, 4


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite's xdist workers share the cores
    (see tests/test_torch_eq9_kernel_route.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(groups=4, arch=ARCH):
    """The reduced configs of ``arch``; a dense LM under Fed2 decouples
    one block, as the reference's LM example does."""
    jc = jax_get_config(arch, reduced=True)
    tc = get_config(arch, reduced=True)
    if groups:
        dec = 1 if jc.family == "dense" else None
        jc = jax_with_fed2(jc, groups=groups, decouple=dec)
        tc = with_fed2(tc, groups=groups, decouple=dec)
    return jc, tc


# ---------------------------------------------------------------------------
# the eval engine's counts mode
# ---------------------------------------------------------------------------


def test_eval_counts_mode_matches_reference():
    """Per-position predictions over (B, L) with each batch's own mask
    and the staging pad mask: (correct, total) sums, equal to the
    reference's."""
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, 5, size=(n, 6)),
                "labels": rng.integers(0, 5, size=(n, 6)),
                "mask": (rng.random((n, 6)) > 0.3).astype(np.float32)}
               for n in (7, 4)]

    def jpredict(params, b):
        return b["tokens"], b["labels"], b["mask"]

    def tpredict(params, b):
        return b["tokens"], b["labels"], b["mask"]

    want = jeval.make_eval_engine(jpredict, None).run(
        None, jeval.stage(batches, tile=4))
    got = evaluation.make_eval_engine(tpredict, None).run(
        None, evaluation.stage(batches, tile=4, device="cpu"))
    assert got.shape == (2,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert evaluation.accuracy(got.numpy()) == jeval.accuracy(want)
    total = sum(b["mask"].sum() for b in batches)
    assert float(got[1]) == total              # pad rows count nothing


# ---------------------------------------------------------------------------
# group axes
# ---------------------------------------------------------------------------


def _axes_by_path(tree):
    """{key path: (axis, n_groups) or None} of a port group-axis tree."""
    out = {}
    for p in tree_paths(tree):
        a = tree
        for k in p:
            a = a[k]
        out[key_path(p)] = None if a is None else (a.axis, a.n_groups)
    return out


def _jax_axes_by_path(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: x is None or isinstance(x,
                                                        jfusion.GroupAxis))
    return {"/".join(str(k) for k in p):
            None if a is None else (a.axis, a.n_groups) for p, a in flat}


@pytest.mark.parametrize("arch,groups", [
    ("mamba2-1.3b", 4), ("mamba2-1.3b", 0), ("llama3.2-1b", 4),
    ("mixtral-8x22b", 4)])
def test_lm_group_axes_match_reference(arch, groups):
    """The whole function as tree logic, on the reference's trees of
    each branch: the unembedding's leading group axis (Mamba-2), the
    decoupled blocks' grouped FFNs (a dense LM's ``gblocks``) and the
    experts of a MoE LM (given the reference's config)."""
    jc = jax_get_config(arch, reduced=True)
    if groups:
        jc = jax_with_fed2(jc, groups=groups)
    shapes = jax.eval_shape(lambda k: jtfm.init_params(k, jc),
                            jax.random.PRNGKey(0))
    jp = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                shapes)
    want = _jax_axes_by_path(jfusion.lm_group_axes(jp, jc))
    got = _axes_by_path(fusion.lm_group_axes(lm_to_port(jp), jc))
    assert got == want
    assert any(v is not None for v in got.values()) == (groups > 0)


# ---------------------------------------------------------------------------
# run_federated(lm_task)
# ---------------------------------------------------------------------------

_DATA = {}


def _data():
    """4 clients, one token domain each (examples/
    llm_federated_finetune.py's split), and a 16-sequence eval set."""
    if not _DATA:
        _, tc = _configs()
        toks, domains = make_token_dataset(120, SEQ + 1, tc.vocab,
                                           n_domains=N_CLIENTS, seed=0)
        test, _ = make_token_dataset(16, SEQ + 1, tc.vocab,
                                     n_domains=N_CLIENTS, seed=7)
        _DATA.update(
            toks=toks, test=test,
            parts=[np.flatnonzero(domains == j) for j in range(N_CLIENTS)])
    return _DATA


def _get_batch(sel):
    sl = _data()["toks"][sel]
    return {"tokens": sl[:, :-1], "labels": sl[:, 1:],
            "mask": np.ones((len(sel), SEQ), np.float32)}


def _test_batches():
    t = _data()["test"]
    return [{"tokens": t[:, :-1], "labels": t[:, 1:],
             "mask": np.ones((len(t), SEQ), np.float32)}]


def _fl(method, **kw):
    return dict(population=N_CLIENTS, rounds=2, local_epochs=1,
                steps_per_epoch=STEPS, batch_size=BATCH, lr=0.01,
                momentum=0.9, method=method, seed=0, eval_batch=16, **kw)


_JAX_RUNS = {}


def _jax_init(arch=ARCH):
    """The reference's reduced Fed2 init of ``arch`` (``init_params`` at
    PRNGKey(0), jitted, drawn once) as numpy."""
    if ("init", arch) not in _JAX_RUNS:
        jc, _ = _configs(arch=arch)
        _JAX_RUNS["init", arch] = jax.tree_util.tree_map(
            np.asarray, jax.jit(lambda k: jtfm.init_params(k, jc))(
                jax.random.PRNGKey(0)))
    return _JAX_RUNS["init", arch]


def _jax_run(method, arch=ARCH):
    """The reference's run from its reduced Fed2 init, and that init;
    cached per (method, arch)."""
    if (method, arch) not in _JAX_RUNS:
        jc, _ = _configs(arch=arch)
        init = _jax_init(arch)

        def get_batch(sel):
            return {k: jnp.asarray(v) for k, v in _get_batch(sel).items()}

        task = dataclasses.replace(jrt.lm_task(jc), init_fn=lambda k: init)
        h = jrt.run_federated(task, jrt.FLConfig(**_fl(method)),
                              _data()["parts"], get_batch, _test_batches())
        _JAX_RUNS[method, arch] = (init, h)
    return _JAX_RUNS[method, arch]


def _port_run(method, init, arch=ARCH, **kw):
    _, tc = _configs(arch=arch)
    return rt.run_federated(rt.lm_task(tc), rt.FLConfig(**_fl(method)),
                            _data()["parts"], _get_batch, _test_batches(),
                            device="cpu", init_params=lm_to_port(init), **kw)


@pytest.mark.parametrize("method", ["fedavg", "fed2"])
def test_run_federated_lm_task_matches_reference(method):
    init, want = _jax_run(method)
    got = _port_run(method, init)
    assert got["round"] == [0, 1] and "confusion" not in got
    n_pos = 16 * SEQ
    np.testing.assert_allclose(got["acc"], want["acc"], atol=1.0 / n_pos)
    for a, b in zip(tree_leaves(got["final_params"]),
                    jax.tree_util.tree_leaves(want["final_params"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("method", ["fedavg", "fed2"])
def test_run_federated_dense_lm_task_matches_reference(method):
    """The same two rounds on the reduced Fed2 llama (one decoupled
    block, whose grouped FFN leaves fed2 fuses per group): final params
    within rtol = atol = 1e-5 and the accuracy within one position, as
    for Mamba-2."""
    init, want = _jax_run(method, "llama3.2-1b")
    got = _port_run(method, init, "llama3.2-1b")
    assert got["round"] == [0, 1] and "gblocks" in got["final_params"]
    np.testing.assert_allclose(got["acc"], want["acc"], atol=1.0 / (16 * SEQ))
    for a, b in zip(tree_leaves(got["final_params"]),
                    jax.tree_util.tree_leaves(want["final_params"])):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_lm_task_refuses_a_mixed_dtype_tree():
    """A bf16 Mamba-2 keeps a_log, dt_bias and d_skip in fp32: one flat
    buffer would round them to bf16, so the engine refuses the tree,
    naming both dtypes, before a round runs; FlatLayout.flatten refuses
    it too. The fp32 config runs."""
    tc = with_fed2(get_config(ARCH, reduced=True, dtype=torch.bfloat16), 4)
    params = rt.lm_task(tc).init_fn(torch.Generator().manual_seed(0))
    assert {t.dtype for t in tree_leaves(params)} == {torch.bfloat16,
                                                      torch.float32}
    with pytest.raises(ValueError, match="bfloat16, float32") as e:
        rt.run_federated(rt.lm_task(tc), rt.FLConfig(**_fl("fed2")),
                         _data()["parts"], _get_batch, _test_batches(),
                         device="cpu", init_params=params)
    assert "mamba2_1_3b.full(dtype=torch.float32)" in str(e.value)
    with pytest.raises(ValueError, match="dtype"):
        FlatLayout(params).flatten(params)
    _, tc32 = _configs()
    h = rt.run_federated(rt.lm_task(tc32),
                         rt.FLConfig(**{**_fl("fed2"), "rounds": 1}),
                         _data()["parts"], _get_batch, _test_batches(),
                         device="cpu")
    assert all(t.dtype == torch.float32
               for t in tree_leaves(h["final_params"]))


def test_lm_task_runs_a_bf16_dense_model_in_bf16():
    """Every leaf of a bf16 llama is bf16, so its cohort buffer is bf16
    too: one fed2 round (with the local_step route) runs, keeps every
    leaf bf16 and finite, and moves the params."""
    _, tc = _configs(arch="llama3.2-1b")
    tc = dataclasses.replace(tc, dtype=torch.bfloat16)
    init = rt.lm_task(tc).init_fn(torch.Generator().manual_seed(0))
    h = rt.run_federated(rt.lm_task(tc),
                         rt.FLConfig(**{**_fl("fed2"), "rounds": 1}),
                         _data()["parts"], _get_batch, _test_batches(),
                         device="cpu", init_params=init,
                         use_local_kernel=True)
    leaves = tree_leaves(h["final_params"])
    assert all(t.dtype == torch.bfloat16 and bool(torch.isfinite(t).all())
               for t in leaves)
    assert any(not torch.equal(a, b)
               for a, b in zip(leaves, tree_leaves(init)))


def test_lm_task_kernel_routes(monkeypatch):
    """fed2 on the LM with ``use_local_kernel``: the group-axis tree
    marks the unembedding, and with shared sample weights the whole
    (C, M) buffer fuses in one paired_fusion call a round; local_step
    runs once a local step. Equal to the plain routes (no kernel call)
    within 1e-6."""
    from repro_torch.fl import methods as methods_mod
    from repro_torch.kernels import paired_fusion as pf
    init, _ = _jax_run("fed2")
    calls = {"paired_fusion": [], "local_step": 0}
    real_pf, real_ls = pf.paired_fusion, methods_mod.local_step

    def pf_counting(*a, **k):
        calls["paired_fusion"].append(tuple(a[0].shape))
        return real_pf(*a, **k)

    def ls_counting(*a, **k):
        calls["local_step"] += 1
        return real_ls(*a, **k)

    monkeypatch.setattr(fusion, "paired_fusion", pf_counting)
    monkeypatch.setattr(methods_mod, "local_step", ls_counting)
    kern = _port_run("fed2", init, use_local_kernel=True)
    m = sum(t.numel() for t in tree_leaves(lm_to_port(init)))
    assert calls == {"paired_fusion": [(N_CLIENTS, m)] * 2,
                     "local_step": 2 * STEPS}
    plain = _port_run("fed2", init, use_kernel=False)
    assert calls["local_step"] == 2 * STEPS and \
        len(calls["paired_fusion"]) == 2
    for a, b in zip(tree_leaves(kern["final_params"]),
                    tree_leaves(plain["final_params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# what an LM task refuses, as the reference does
# ---------------------------------------------------------------------------


def test_lm_task_refuses_tiers():
    _, tc = _configs()
    task = rt.lm_task(tc)
    assert task.tier_fn is None and task.n_classes is None
    fl = rt.FLConfig(**{**_fl("fedavg"), "tiers": "1.0x2,0.5x2"})
    plan = capacity.TierPlan.from_mix(fl.tiers, N_CLIENTS, seed=0)
    with pytest.raises(ValueError, match="tier_fn"):
        capacity.make_tiered_engine(task, fl, None, plan, device="cpu",
                                    method=methods.get("fedavg"))


def test_lm_task_refuses_data_poisoning():
    init, _ = _jax_run("fedavg")
    with pytest.raises(ValueError, match="poisons labels and needs "
                                         "task.n_classes"):
        _port_run_cfg(dict(attack="label_flip", attack_fraction=0.25), init)


def _port_run_cfg(over, init):
    _, tc = _configs()
    cfg = rt.FLConfig(**{**_fl("fedavg"), **over})
    return rt.run_federated(rt.lm_task(tc), cfg, _data()["parts"],
                            _get_batch, _test_batches(), device="cpu",
                            init_params=lm_to_port(init))


def test_lm_task_refuses_host_fusion():
    _, tc = _configs()
    task = rt.lm_task(tc)
    assert task.matched_average_fn is None
    params = task.init_fn(torch.Generator().manual_seed(0))
    cfg = rt.FLConfig(**_fl("fedma"))
    with pytest.raises(ValueError, match="fedma requires "
                                         "task.matched_average_fn"):
        make_round_engine(task, cfg, params, device="cpu")


def test_lm_task_model_poisoning_runs():
    """A model-poisoning attack needs no n_classes: the LM round takes
    it (sign_flip on one of the four clients, fedavg)."""
    init, _ = _jax_run("fedavg")
    h = _port_run_cfg(dict(attack="sign_flip(4)", attack_fraction=0.25,
                           rounds=1), init)
    assert len(h["acc"]) == 1
    assert all(bool(torch.isfinite(t).all())
               for t in tree_leaves(h["final_params"]))


def test_lm_task_init_matches_the_reference_tree():
    jc, tc = _configs()
    got = rt.lm_task(tc).init_fn(torch.Generator().manual_seed(0))
    shapes = jax.eval_shape(lambda k: jtfm.init_params(k, jc),
                            jax.random.PRNGKey(0))
    assert [tuple(t.shape) for t in tree_leaves(got)] == \
        [tuple(s.shape) for s in jax.tree_util.tree_leaves(shapes)]
    assert dataclasses.asdict(tc.ssm) == dataclasses.asdict(jc.ssm)
