"""Port kernels' wrappers on the CPU (their plain versions) against the
reference's oracles (``repro.kernels.ref``) and its interpret-mode
Pallas wrappers (``repro.kernels.ops``), on the same numpy inputs.

Tolerances: fp32 1e-5 for fusion and 1e-6 for the local step, the
reference's own (tests/test_kernels.py); bf16 2e-2, one bf16 step at
the values' magnitude (< 4), since the two frameworks may round the
fp32 result to bf16 from sums that differ in the last fp32 bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import local_step as ls
from repro_torch.kernels import paired_fusion as pf

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _rows(n, m, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, m)).astype(np.float32)
    w = (np.abs(rng.normal(size=n)) + 0.1).astype(np.float32)
    return x, w / w.sum()


def _t(a, dtype):
    return torch.tensor(a).to(dtype)


def _np(t):
    return t.to(torch.float32).numpy()


@pytest.mark.parametrize("n,m", [(10, 128), (4, 231), (1, 7), (3, 1000),
                                 (2, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paired_fusion_matches_reference(n, m, dtype):
    tdt, jdt = DTYPES[dtype]
    x, w = _rows(n, m)
    before = pf.paired_fusion.launches
    got = pf.paired_fusion(_t(x, tdt), torch.tensor(w))
    assert got.dtype == tdt and got.shape == (m,)
    assert pf.paired_fusion.launches == before   # CPU: the plain version
    xj = jnp.asarray(x).astype(jdt)
    want_ref = ref.paired_fusion_ref(xj, jnp.asarray(w))
    want_ops = ops.paired_fusion(xj, jnp.asarray(w))
    tol = 1e-5 if dtype == "float32" else 2e-2
    for want in (want_ref, want_ops):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   atol=tol)


def test_paired_fusion_strided_rows_into_out_slice():
    """The engine's call shape: rows are a column range of a wider
    buffer, and the result lands in a slice of a larger vector."""
    x, w = _rows(5, 300, seed=1)
    buf = torch.zeros(5, 320)
    buf[:, 17:317] = torch.tensor(x)
    out = torch.full((400,), 7.0)
    res = pf.paired_fusion(buf[:, 17:317], torch.tensor(w),
                           out=out[50:350])
    assert res.data_ptr() == out[50:].data_ptr()
    want = ref.paired_fusion_ref(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(out[50:350].numpy(), np.asarray(want),
                               atol=1e-5)
    assert (out[:50] == 7).all() and (out[350:] == 7).all()


def test_paired_fusion_rejects_bad_inputs():
    x = torch.zeros(3, 8)
    with pytest.raises(ValueError):
        pf.paired_fusion(x.reshape(3, 2, 4), torch.ones(3) / 3)
    with pytest.raises(ValueError):
        pf.paired_fusion(x, torch.ones(3, dtype=torch.float64) / 3)
    with pytest.raises(ValueError):
        pf.paired_fusion(x.t(), torch.ones(8) / 8)      # column stride 3
    with pytest.raises(TypeError):
        pf.paired_fusion(x.half(), torch.ones(3) / 3)


def _psv(m, seed=0, rows=None):
    rng = np.random.default_rng(seed)
    shape = (m,) if rows is None else (rows, m)
    return (rng.normal(size=shape).astype(np.float32),
            (0.1 * rng.normal(size=shape)).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("m", [1, 64, 1000, 5000])
@pytest.mark.parametrize("mu", [0.0, 0.9])
def test_local_step_matches_reference(m, mu):
    p, v, g = _psv(m)
    tp, tv, tg = (torch.tensor(a) for a in (p, v, g))
    before = ls.local_step.launches
    rp, rv = ls.local_step(tp, tv, tg, lr=0.05, mu=mu)
    assert rp is tp and rv is tv                      # in place
    assert ls.local_step.launches == before
    pr, vr = ref.local_step_ref(jnp.asarray(p), jnp.asarray(v),
                                jnp.asarray(g), lr=0.05, mu=mu)
    po, vo = ops.local_step(jnp.asarray(p), jnp.asarray(v), jnp.asarray(g),
                            lr=0.05, mu=mu)
    for wp, wv in ((pr, vr), (po, vo)):
        np.testing.assert_allclose(tp.numpy(), np.asarray(wp), atol=1e-6)
        np.testing.assert_allclose(tv.numpy(), np.asarray(wv), atol=1e-6)


def test_local_step_bf16_storage_fp32_compute():
    p, v, g = _psv(512, seed=3)
    tp, tv, tg = (torch.tensor(a).bfloat16() for a in (p, v, g))
    ls.local_step(tp, tv, tg, lr=0.05, mu=0.9)
    assert tp.dtype == torch.bfloat16 and tv.dtype == torch.bfloat16
    jp, jv, jg = (jnp.asarray(a).astype(jnp.bfloat16) for a in (p, v, g))
    pr, vr = ref.local_step_ref(jp, jv, jg, lr=0.05, mu=0.9)
    np.testing.assert_allclose(_np(tp), np.asarray(pr, np.float32),
                               atol=2e-2)
    np.testing.assert_allclose(_np(tv), np.asarray(vr, np.float32),
                               atol=2e-2)


def test_local_step_on_strided_cohort_rows():
    """The engine's call shape: (C, M) views of a (C, stride) buffer,
    updated in place row by row, pad columns untouched."""
    c, m = 3, 700
    p, v, g = _psv(m, seed=4, rows=c)
    pbuf = torch.full((c, 768), 5.0)
    vbuf = torch.full((c, 768), 5.0)
    pbuf[:, :m], vbuf[:, :m] = torch.tensor(p), torch.tensor(v)
    ls.local_step(pbuf[:, :m], vbuf[:, :m], torch.tensor(g), lr=0.1,
                  mu=0.9)
    for i in range(c):
        pr, vr = ref.local_step_ref(jnp.asarray(p[i]), jnp.asarray(v[i]),
                                    jnp.asarray(g[i]), lr=0.1, mu=0.9)
        np.testing.assert_allclose(pbuf[i, :m].numpy(), np.asarray(pr),
                                   atol=1e-6)
        np.testing.assert_allclose(vbuf[i, :m].numpy(), np.asarray(vr),
                                   atol=1e-6)
    assert (pbuf[:, m:] == 5).all() and (vbuf[:, m:] == 5).all()


def test_local_step_rejects_bad_inputs():
    with pytest.raises(ValueError):
        ls.local_step(torch.zeros(4), torch.zeros(5), torch.zeros(4),
                      lr=0.1, mu=0.9)
    with pytest.raises(TypeError):
        ls.local_step(torch.zeros(4).double(), torch.zeros(4).double(),
                      torch.zeros(4).double(), lr=0.1, mu=0.9)
