"""The port's byzantine attacks (``repro_torch.fl.attacks``) against the
reference's (``repro.fl.attacks``).

- ``assign_attackers`` draws the reference's ids to the bit (numpy,
  the seed + 14407 stream); ``attacker_count`` and ``parse_attack``
  refuse with the reference's messages.
- ``sign_flip``/``scaled_update`` poison the malicious rows as the
  reference's vmapped ``poison_update`` does, in fp32 and in bf16 (the
  product in bf16, subtracted from the fp32 global for sign_flip), and
  leave honest rows untouched, to the bit.
- ``gauss_noise``: the reference folds jax keys per (round, slot, leaf),
  which torch cannot draw; with the reference's noise injected the two
  agree to the bit. The port's own draw is seeded per (round, slot,
  leaf): deterministic, and a new draw each round.
- One round under ``sign_flip(4)`` (fedavg) matches the reference
  from its converted init: final
  parameters within 1e-4, accuracy within one eval example (the
  tolerances of tests/test_torch_runtime.py).
- A cohort that samples no attacker computes the honest round to the
  bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import attacks as jattacks
from repro.fl import runtime as jruntime
from repro.fl import scenarios as jscen
from repro_torch import convert
from repro_torch.fl import attacks as tattacks
from repro_torch.fl import runtime as truntime
from repro_torch.fl import scenarios as tscen
from repro_torch.models.module import FlatLayout

SMALL = dict(train_size=240, test_size=80, steps_per_epoch=3, batch_size=8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's xdist workers share the cores
    (see tests/test_torch_eq9_kernel_route.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("fraction,population,seed", [
    (0.2, 10, 0), (0.2, 10, 1), (3, 10, 5), (0.5, 64, 2), (1, 2, 9),
    (0.1, 1000, 3)])
def test_assign_attackers_equals_reference(fraction, population, seed):
    np.testing.assert_array_equal(
        tattacks.assign_attackers(fraction, population, seed=seed),
        jattacks.assign_attackers(fraction, population, seed=seed))


def _msg(fn, *a, **k):
    try:
        fn(*a, **k)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("fraction,population", [
    (0.0, 10), (-1, 10), (1.5, 10), (0.01, 10), (10, 10), (0.99, 10)])
def test_attacker_count_refusals_match(fraction, population):
    got = _msg(tattacks.attacker_count, fraction, population)
    assert got is not None
    assert got == _msg(jattacks.attacker_count, fraction, population)


@pytest.mark.parametrize("spec", ["label_flip", "sign_flip(4)",
                                  "scaled_update", "gauss_noise(0.5)",
                                  "label_flip(2)", "teleport", "sign_flip(",
                                  "sign_flip(x)"])
def test_parse_attack_matches_reference(spec):
    got = _msg(tattacks.parse_attack, spec)
    assert got == _msg(jattacks.parse_attack, spec)
    if got is None:
        t, j = tattacks.parse_attack(spec), jattacks.parse_attack(spec)
        assert (t.name, t.param, t.describe()) == (j.name, j.param,
                                                   j.describe())
        tb, jb = t.build(), j.build()
        assert (tb.data_poisoning, tb.model_poisoning, tb.needs_rng,
                tb.param) == (jb.data_poisoning, jb.model_poisoning,
                              jb.needs_rng, jb.param)


def test_label_flip_batch_matches_reference():
    batch = {"images": np.zeros((4, 2), np.float32),
             "labels": np.array([0, 3, 9, 5], np.int32)}
    got = tattacks.get("label_flip").poison_batch(batch, 10)
    want = jattacks.get("label_flip").poison_batch(
        {k: jnp.asarray(v) for k, v in batch.items()}, 10)
    np.testing.assert_array_equal(got["labels"], np.asarray(want["labels"]))
    assert got["labels"].dtype == np.int32


C = 5
MAL = np.array([0, 1, 0, 1, 0], np.float32)


def _tree_inputs(dtype):
    """A (C, ...) stacked tree, its fp32 global and the port's flat
    views of both."""
    rng = np.random.default_rng(1)
    tree = {"a": rng.normal(size=(C, 3, 4)), "b": rng.normal(size=(C, 7))}
    glob = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32)}
    layout = FlatLayout({k: torch.zeros(v.shape[1:])
                         for k, v in tree.items()})
    jtree = {k: jnp.asarray(v, dtype) for k, v in tree.items()}
    tdt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype]
    flat = layout.flatten({k: torch.tensor(v, dtype=torch.float32)
                           for k, v in tree.items()}).to(tdt)
    gflat = layout.flatten({k: torch.tensor(v) for k, v in glob.items()})
    return jtree, glob, layout, flat, gflat


def _ref_poison(attack, jtree, glob, key=None):
    keys = (jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        key, jnp.arange(C)) if key is not None
        else jnp.zeros((C, 2), jnp.uint32))
    return jax.vmap(attack.poison_update, in_axes=(0, None, 0, 0))(
        jtree, glob, jnp.asarray(MAL), keys)


def _as_flat(layout, tree, dtype):
    return layout.flatten({k: torch.tensor(np.asarray(v, np.float32))
                           for k, v in tree.items()}).to(dtype)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("spec", ["sign_flip(4)", "scaled_update(3)",
                                  "sign_flip"])
def test_model_poisoning_matches_reference(spec, dtype):
    jtree, glob, layout, flat, gflat = _tree_inputs(dtype)
    want = _ref_poison(jattacks.parse_attack(spec).build(), jtree, glob)
    got = tattacks.parse_attack(spec).build().poison_update(flat, gflat, MAL)
    assert got.dtype == flat.dtype
    assert torch.equal(got, _as_flat(layout, want, flat.dtype))
    honest = torch.as_tensor(MAL == 0)
    assert torch.equal(got[honest], flat[honest])


def test_gauss_noise_matches_reference_on_injected_noise():
    jtree, glob, layout, flat, gflat = _tree_inputs(jnp.float32)
    key = jattacks.round_key(0, 3)
    jatk = jattacks.get("gauss_noise", 0.5)
    want = _ref_poison(jatk, jtree, glob, key)
    # the reference's draws: leaf i of slot c from fold_in(fold_in(key,
    # c), i), in the reference's leaf order (sorted keys, as the port's)
    eps = {}
    for i, (name, leaf) in enumerate(sorted(jtree.items())):
        eps[name] = np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(jax.random.fold_in(key, c), i),
            leaf.shape[1:], leaf.dtype)) for c in range(C)])
    noise = _as_flat(layout, eps, torch.float32)
    tatk = tattacks.get("gauss_noise", 0.5)
    got = tatk.poison_update(flat, gflat, MAL, tattacks.round_key(0, 3),
                             layout, noise=noise)
    assert torch.equal(got, _as_flat(layout, want, torch.float32))


def test_gauss_noise_port_draw_is_seeded_per_round():
    _, _, layout, flat, gflat = _tree_inputs(jnp.float32)
    atk = tattacks.get("gauss_noise")
    a = atk.poison_update(flat, gflat, MAL, tattacks.round_key(0, 1), layout)
    b = atk.poison_update(flat, gflat, MAL, tattacks.round_key(0, 1), layout)
    c = atk.poison_update(flat, gflat, MAL, tattacks.round_key(0, 2), layout)
    assert torch.equal(a, b)
    mal = torch.as_tensor(MAL > 0)
    assert not torch.equal(a[mal], c[mal])
    assert torch.equal(a[~mal], flat[~mal])
    d = (a - flat)[mal]
    assert abs(float(d.std()) - 1.0) < 0.3      # sigma 1 noise


def _run_both(name, **over):
    kw = {**SMALL, **over}
    tspec, jspec = tscen.get(name).override(**kw), jscen.get(name).override(
        **kw)
    ds, test = tspec.datasets()
    parts = tspec.partition(ds.labels)
    jtask = jruntime.cnn_task(jspec.model_config())
    init = jax.tree_util.tree_map(
        np.asarray, jtask.init_fn(jax.random.PRNGKey(jspec.seed)))
    tests = [{"images": test.images, "labels": test.labels}]
    hj = jruntime.run_federated(
        jtask, jspec.fl_config(), parts,
        lambda s: {"images": jnp.asarray(ds.images[s]),
                   "labels": jnp.asarray(ds.labels[s])}, tests, mesh=None,
        use_kernel=False)
    ht = truntime.run_federated(
        truntime.cnn_task(tspec.model_config()), tspec.fl_config(), parts,
        lambda s: {"images": ds.images[s], "labels": ds.labels[s]}, tests,
        device="cpu", init_params=convert.to_port(init))
    return hj, ht


def test_one_attacked_round_matches_reference():
    """sign_flip(4) on fedavg here; label_flip (fedavg) and sign_flip
    under trimmed_mean (fed2) run two rounds in
    tests/test_torch_scenarios.py."""
    hj, ht = _run_both("nxc2_fedavg_signflip20", rounds=1)
    np.testing.assert_allclose(ht["acc"], hj["acc"],
                               atol=1 / SMALL["test_size"] + 1e-9)
    got = jax.tree_util.tree_leaves(convert.to_reference(ht["final_params"]))
    want = jax.tree_util.tree_leaves(hj["final_params"])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)


def test_zero_attacker_cohort_is_the_honest_round():
    """One attacker (client 6 at seed 0); round_robin at cohort 5 trains
    clients 0-4 in round 0, so the attacked run's round is the honest
    one to the bit."""
    assert np.flatnonzero(tattacks.assign_attackers(1, 10, seed=0)) == [6]
    spec = tscen.get("nxc2_fedavg_signflip20").override(
        rounds=1, attack_fraction=1, sampler="round_robin", cohort_size=5,
        **SMALL)
    ds, test = spec.datasets()
    parts = spec.partition(ds.labels)
    task = truntime.cnn_task(spec.model_config())
    init = task.init_fn(torch.Generator().manual_seed(0))
    finals = []
    for attack in ("sign_flip(4)", None):
        cfg = dataclasses.replace(spec.fl_config(), attack=attack,
                                  attack_fraction=1 if attack else 0.0)
        h = truntime.run_federated(
            task, cfg, parts,
            lambda s: {"images": ds.images[s], "labels": ds.labels[s]},
            [{"images": test.images, "labels": test.labels}],
            device="cpu", init_params=init)
        finals.append(FlatLayout(init).flatten(h["final_params"]))
    assert torch.equal(finals[0], finals[1])
