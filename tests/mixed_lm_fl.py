"""Shared inputs of the mixed-dtype LM federation tests
(``tests/test_torch_lm_fl_mixed*.py``): the reduced Fed2 Mamba-2 at
``dtype=bfloat16``, whose tree keeps ``a_log``, ``dt_bias`` and
``d_skip`` in fp32, federated by both packages from the reference's
init (``PRNGKey(0)``, converted by ``convert.lm_to_port``) on the data
of ``tests/test_torch_lm_fl.py``: 4 clients, one token domain each, 2
local momentum-SGD steps of batch 4 at seq 16, lr 0.01.

Tolerances, per leaf dtype:

- fp32 leaves within ``FP32_UPDATE_RTOL`` = 10 % of their largest
  update in the reference's run. The forward runs in bf16, and the two
  packages round it differently (XLA fuses elementwise chains and keeps
  their intermediates in fp32; torch rounds every op): at the init one
  batch's gradients differ by 2-7 % of their largest element, leaf by
  leaf, and the bf16 hidden states by up to 0.15 where each package is
  0.2 from the fp32 forward. So the fp32 leaves' updates differ by 2.4-
  3.4 % of their size (measured: a_log 1.82e-5 of 5.59e-4 over two
  rounds, d_skip 5.48e-5 of 1.88e-3, dt_bias 2.57e-5 of 8.72e-4). The
  absolute 1e-5 that an fp32 forward holds (tests/test_torch_lm_fl.py)
  does not hold here. An fp32 leaf that went through bf16 misses by far
  more: ``a_log`` lies up to 7.3e-3 off the bf16 grid (half an ulp at
  ln 16 is 7.8e-3), and a lost update misses by 100 % of it.
- bf16 leaves within ``BF16_ATOL`` = 2^-7 absolute, the limit of
  ``tests/test_torch_axes.py``; measured 9.8e-4 after one round and
  1.95e-3 after two: a rounding that differs once moves a leaf by one
  ulp, and that compounds through the next steps' gradients.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.common import with_fed2 as jax_with_fed2
from repro.data.synthetic import make_token_dataset
from repro.fl import runtime as jrt
from repro.models import transformer as jtfm
from repro_torch.configs import get_config
from repro_torch.configs.common import with_fed2
from repro_torch.convert import lm_to_port
from repro_torch.fl import runtime as rt
from repro_torch.models.module import tree_leaves, tree_leaves_with_path

ARCH = "mamba2-1.3b"
SEQ, N_CLIENTS, STEPS, BATCH = 16, 4, 2, 4
FP32_UPDATE_RTOL = 0.1
BF16_ATOL = 2.0 ** -7
FP32_LEAVES = ("a_log", "d_skip", "dt_bias")


def configs():
    """The reduced Fed2 Mamba-2 (4 groups) at bf16 in both packages."""
    jc = jax_with_fed2(jax_get_config(ARCH, reduced=True,
                                      dtype=jnp.bfloat16), groups=4)
    tc = with_fed2(get_config(ARCH, reduced=True, dtype=torch.bfloat16),
                   groups=4)
    return jc, tc


_DATA = {}


def data():
    if not _DATA:
        _, tc = configs()
        toks, domains = make_token_dataset(120, SEQ + 1, tc.vocab,
                                           n_domains=N_CLIENTS, seed=0)
        test, _ = make_token_dataset(16, SEQ + 1, tc.vocab,
                                     n_domains=N_CLIENTS, seed=7)
        _DATA.update(
            toks=toks, test=test,
            parts=[np.flatnonzero(domains == j) for j in range(N_CLIENTS)])
    return _DATA


def get_batch(sel):
    sl = data()["toks"][sel]
    return {"tokens": sl[:, :-1], "labels": sl[:, 1:],
            "mask": np.ones((len(sel), SEQ), np.float32)}


def test_batches():
    t = data()["test"]
    return [{"tokens": t[:, :-1], "labels": t[:, 1:],
             "mask": np.ones((len(t), SEQ), np.float32)}]


def fl(method, rounds, **kw):
    return dict(population=N_CLIENTS, rounds=rounds, local_epochs=1,
                steps_per_epoch=STEPS, batch_size=BATCH, lr=0.01,
                momentum=0.9, method=method, seed=0, eval_batch=16, **kw)


_RUNS = {}


def jax_init():
    """The reference's init as numpy (bf16 leaves as ml_dtypes')."""
    if "init" not in _RUNS:
        jc, _ = configs()
        _RUNS["init"] = jax.tree_util.tree_map(
            np.asarray, jax.jit(lambda k: jtfm.init_params(k, jc))(
                jax.random.PRNGKey(0)))
    return _RUNS["init"]


def jax_run(method, rounds, use_local_kernel=False, **kw):
    """The reference's ``run_federated(lm_task)`` from ``jax_init``,
    cached. Its eval sees the global cast to the init's dtypes: fedadam's
    server step promotes a bf16 leaf to fp32 (its step count is a strong
    fp32 scalar), and the forward's scan then refuses the tree. The round
    and ``final_params`` are the reference's own."""
    key = (method, rounds, use_local_kernel, tuple(sorted(kw.items())))
    if key not in _RUNS:
        jc, _ = configs()
        init = jax_init()
        task = jrt.lm_task(jc)
        predict = task.predict_fn

        def cast_predict(params, batch):
            return predict(jax.tree_util.tree_map(
                lambda p, i: p.astype(i.dtype), params, init), batch)

        def jget(sel):
            return {k: jnp.asarray(v) for k, v in get_batch(sel).items()}

        task = dataclasses.replace(task, init_fn=lambda k: init,
                                   predict_fn=cast_predict)
        _RUNS[key] = jrt.run_federated(
            task, jrt.FLConfig(**fl(method, rounds, **kw)), data()["parts"],
            jget, test_batches(), use_local_kernel=use_local_kernel)
    return _RUNS[key]


def port_run(method, rounds, fl_kw=None, **kw):
    _, tc = configs()
    return rt.run_federated(rt.lm_task(tc),
                            rt.FLConfig(**fl(method, rounds, **(fl_kw or {}))),
                            data()["parts"], get_batch, test_batches(),
                            device="cpu", init_params=lm_to_port(jax_init()),
                            **kw)


def leaf_diffs(got, want, like=None) -> dict:
    """{leaf path: (port dtype, max |port - reference|, max |reference -
    init|)}; every port leaf has the dtype of ``like``'s (a torch tree;
    default: the reference's)."""
    out = {}
    want_leaves = jax.tree_util.tree_leaves(want)
    init = jax.tree_util.tree_leaves(jax_init())
    like = ([None] * len(want_leaves) if like is None
            else tree_leaves(like))
    for (path, a), b, i, lk in zip(tree_leaves_with_path(got), want_leaves,
                                   init, like, strict=True):
        expect = lk.dtype if lk is not None else getattr(torch, str(b.dtype))
        assert a.dtype == expect, (path, a.dtype, b.dtype)
        b = np.asarray(b, np.float32)
        out[path] = (a.dtype,
                     float(np.max(np.abs(a.float().numpy() - b))),
                     float(np.max(np.abs(b - np.asarray(i, np.float32)))))
    return out


def assert_parity(got, want, like=None, extra=None) -> dict:
    """fp32 leaves within FP32_UPDATE_RTOL of their update, bf16 leaves
    within BF16_ATOL, every leaf in the reference's dtype (or ``like``'s).
    ``extra``: {leaf path: an absolute allowance added to its limit}.
    Returns the diffs."""
    diffs = leaf_diffs(got, want, like)
    for path, (dt, d, upd) in diffs.items():
        tol = FP32_UPDATE_RTOL * upd if dt == torch.float32 else BF16_ATOL
        tol += (extra or {}).get(path, 0.0)
        assert d <= tol, (path, dt, d, tol)
    assert {dt for dt, _, _ in diffs.values()} == {torch.bfloat16,
                                                    torch.float32}
    assert all(dt == torch.float32 for p, (dt, _, _) in diffs.items()
               if any(k in p for k in FP32_LEAVES))
    return diffs


def fp32_moved(h, init) -> float:
    """The least any fp32 leaf moved from ``init`` (a bf16 leaf may
    round back to its init, in both packages: an update under half its
    ulp is lost)."""
    return min((a - b).abs().max().item()
               for a, b in zip(tree_leaves(h["final_params"]),
                               tree_leaves(init))
               if a.dtype == torch.float32)
