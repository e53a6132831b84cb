"""Port kernels' wrappers on the CPU (their plain versions) against the
reference's oracles (``repro.kernels.ref``) and its interpret-mode
Pallas wrappers (``repro.kernels.ops``), on the same numpy inputs.

Tolerances: fp32 1e-5 for fusion and 1e-6 for the local step, the
reference's own (tests/test_kernels.py); bf16 2e-2, one bf16 step at
the values' magnitude (< 4), since the two frameworks may round the
fp32 result to bf16 from sums that differ in the last fp32 bit.
``ssd_update``: fp32 rtol = atol = 1e-5 (sums of N terms in another
order); bf16 y within 1e-2 relative (one bf16 step), h' fp32 as above.
``grouped_matmul``: atol 1e-4·√K and rtol 1e-4 fp32, 0.3·√K and 0.3
bf16, the reference's (tests/test_kernels.py).
"""
import itertools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import build
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels import local_step as ls
from repro_torch.kernels import paired_fusion as pf
from repro_torch.kernels import ssd_update as su
from repro_torch.models.layers import grouped_dense_apply

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


# ---------------------------------------------------------------------------
# ssd_update
# ---------------------------------------------------------------------------


def _ssd_inputs(b, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(b, h, p, n)).astype(f),
            rng.normal(size=(b, h, p)).astype(f),
            np.log1p(np.exp(rng.normal(size=(b, h)))).astype(f),
            np.log(np.linspace(1.0, 16.0, h)).astype(f),
            rng.normal(size=(b, n)).astype(f),
            rng.normal(size=(b, n)).astype(f),
            (1.0 + 0.1 * rng.normal(size=h)).astype(f))


# H = 3, 5, 20: not multiples of the TPU kernel's head block (8), so
# ops.ssd_update pads; (2, 5, 7, 9) is ragged in P and N as well
@pytest.mark.parametrize("b,h,p,n", [(2, 8, 16, 32), (1, 3, 8, 8),
                                     (4, 20, 32, 64), (2, 5, 7, 9)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_update_matches_reference(b, h, p, n, dtype):
    tdt, jdt = DTYPES[dtype]
    hs, x, dt, a_log, bm, cm, d = _ssd_inputs(b, h, p, n)
    t = [torch.tensor(a) for a in (hs, x, dt, a_log, bm, cm, d)]
    t[1], t[4], t[5] = t[1].to(tdt), t[4].to(tdt), t[5].to(tdt)
    before = su.ssd_update.launches
    got_h, got_y = su.ssd_update(*t)
    assert su.ssd_update.launches == before      # CPU: the plain version
    assert got_h.dtype == torch.float32 and got_y.dtype == tdt
    plain = su.ssd_update_ref(*t)
    assert torch.equal(plain[0], got_h) and torch.equal(plain[1], got_y)
    j = [jnp.asarray(a) for a in (hs, x, dt, a_log, bm, cm, d)]
    j[1], j[4], j[5] = j[1].astype(jdt), j[4].astype(jdt), j[5].astype(jdt)
    for want_h, want_y in (ref.ssd_update_ref(*j), ops.ssd_update(*j)):
        np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                                   rtol=1e-5, atol=1e-5)
        tol = 1e-5 if dtype == "float32" else 1e-2
        np.testing.assert_allclose(_np(got_y), np.asarray(want_y,
                                                          np.float32),
                                   rtol=tol, atol=tol)


def test_ssd_update_in_place_and_decode_views():
    """The decode's call: x, b and c are views into one wide (B, C) row
    (only their batch stride is free) and h' goes into the state's own
    buffer."""
    b, h, p, n = 3, 4, 8, 16
    hs, x, dt, a_log, bm, cm, d = _ssd_inputs(b, h, p, n, seed=5)
    row = torch.zeros(b, h * p + 2 * n + 5)
    row[:, :h * p] = torch.tensor(x).reshape(b, h * p)
    row[:, h * p:h * p + n] = torch.tensor(bm)
    row[:, h * p + n:h * p + 2 * n] = torch.tensor(cm)
    xv = row[:, :h * p].reshape(b, h, p)
    bv, cv = row[:, h * p:h * p + n], row[:, h * p + n:h * p + 2 * n]
    assert not xv.is_contiguous() and not bv.is_contiguous()
    state = torch.tensor(hs)
    got_h, got_y = su.ssd_update(state, xv, torch.tensor(dt),
                                 torch.tensor(a_log), bv, cv,
                                 torch.tensor(d), out=state)
    assert got_h is state
    want_h, want_y = ref.ssd_update_ref(*(jnp.asarray(a) for a in (
        hs, x, dt, a_log, bm, cm, d)))
    np.testing.assert_allclose(state.numpy(), np.asarray(want_h),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               rtol=1e-5, atol=1e-5)


def test_ssd_update_matches_the_models_step():
    """The plain version is the model's decode recurrence
    (``models.ssm.ssd_step``), as the reference's kernel is its."""
    from repro_torch.models.ssm import ssd_step
    t = [torch.tensor(a) for a in _ssd_inputs(2, 6, 8, 16, seed=2)]
    kh, ky = su.ssd_update(*t)
    sh, sy = ssd_step(*t)
    np.testing.assert_allclose(kh.numpy(), sh.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ky.numpy(), sy.numpy(), rtol=1e-6, atol=1e-6)


def test_ssd_update_rejects_bad_inputs():
    t = [torch.tensor(a) for a in _ssd_inputs(2, 3, 4, 8)]
    with pytest.raises(ValueError):                   # b of the wrong N
        su.ssd_update(*t[:4], t[4][:, :5], *t[5:])
    with pytest.raises(TypeError):                    # bf16 state
        su.ssd_update(t[0].bfloat16(), *t[1:])
    with pytest.raises(TypeError):                    # x and b differ
        su.ssd_update(t[0], t[1].bfloat16(), *t[2:])
    with pytest.raises(ValueError):                   # x with P strided
        su.ssd_update(t[0], t[1].transpose(1, 2).contiguous()
                      .transpose(1, 2), *t[2:])
    with pytest.raises(ValueError):                   # out of another shape
        su.ssd_update(*t, out=torch.zeros(2, 3, 4, 9))


def _check_plan(plan, b, h, p, n, esize, sms=132):
    """A plan the kernel takes (csrc/ssd_update.cu's checks), whose
    dynamic shared memory fits a block (227 KB; 48 KB takes no opt-in)
    and the blocks an SM runs at once. On the TMA route a unit is whole
    passes of the block's rows, or all of P (or MAX_UNIT_ROWS, less than
    a pass at N = 4)."""
    if plan.route == "scalar":
        assert n <= su.SCALAR_MAX_N and plan.unit_rows == p
        smem = 2 * n * 4                          # b and c as fp32
    else:
        assert n % 4 == 0 and 4 <= n <= su.TMA_MAX_N
        pass_rows = su.THREADS // su.lanes_per_row(n)
        assert 1 <= plan.unit_rows <= min(p, su.MAX_PASSES * pass_rows,
                                          su.MAX_UNIT_ROWS)
        assert plan.unit_rows % pass_rows == 0 or \
            plan.unit_rows in (p, su.MAX_UNIT_ROWS)
        assert plan.unit_rows * esize % 4 == 0   # x's rows in 4-byte copies
        assert plan.unit_rows * n * 4 <= su.UNIT_BYTES
        # the unit's state, then its side data: at most 3 words a thread
        assert 3 + (plan.unit_rows + 2 * n) * esize // 4 <= 3 * su.THREADS
        smem = plan.unit_rows * n * 4 + 3 * su.THREADS * 4
    assert smem <= 48 * 1024 <= 227 * 1024
    # the SM's 228 KB hold the blocks it runs at once (the TMA route's
    # MIN_BLOCKS, which its __launch_bounds__ asks for), 1 KB reserved
    # for each
    per_sm = 1 if plan.route == "scalar" else su.MIN_BLOCKS
    assert per_sm * (smem + 1024) <= 233472


def _decode_row(b, h, p, n, esize, base=1 << 20, offs=(0,) * 5, pad=0):
    """route()'s pointers and strides for x, b and c as the decode cuts
    them from one (B, H*P + 2N + pad) row, the state and h' apart."""
    width = h * p + 2 * n + pad
    ptrs = (base, base + 8 * b * h * p * n, 1 << 32,
            (1 << 32) + h * p * esize, (1 << 32) + (h * p + n) * esize)
    return tuple(q + o for q, o in zip(ptrs, offs)), (width,) * 3


# the full-width layers (Mamba-2 1.3B, Zamba2-2.7B at batch 4 and 128,
# bf16 x), then the shapes and addresses that take the scalar route,
# then ragged ones the TMA route takes (N = 36: 9 chunks on 16 lanes;
# N = 256: 2 chunks a lane; N = 8 and 4: 2 and 1 lanes a row)
@pytest.mark.parametrize("b,h,p,n,esize,offs,pad,want", [
    (4, 64, 64, 128, 2, (0,) * 5, 0, "tma"),
    (128, 64, 64, 128, 2, (0,) * 5, 0, "tma"),
    (4, 80, 64, 64, 2, (0,) * 5, 0, "tma"),
    (128, 80, 64, 64, 2, (0,) * 5, 0, "tma"),
    (4, 80, 64, 64, 4, (0,) * 5, 0, "tma"),            # fp32 x
    (4, 64, 64, 128, 2, (4, 4, 0, 0, 0), 0, "scalar"),  # state off 16 B
    (4, 80, 64, 64, 2, (0, 4, 0, 0, 0), 0, "scalar"),   # h' off 16 bytes
    (4, 80, 64, 64, 2, (0, 0, 2, 2, 2), 0, "scalar"),   # x, b, c off 4 B
    (4, 80, 64, 64, 2, (0,) * 5, 1, "scalar"),          # odd bf16 stride
    (4, 80, 64, 64, 4, (0,) * 5, 1, "tma"),             # fp32: any stride
    (3, 5, 7, 9, 4, (0,) * 5, 0, "scalar"),             # N % 4 != 0
    (2, 6, 33, 130, 4, (0,) * 5, 0, "scalar"),
    (1, 1, 1, 1, 4, (0,) * 5, 0, "scalar"),
    (2, 9, 100, 260, 4, (0,) * 5, 0, "scalar"),         # N > 256
    (2, 4, 8, 6144, 4, (0,) * 5, 0, "scalar"),          # the widest N
    (3, 5, 7, 8, 2, (0,) * 5, 0, "scalar"),             # odd bf16 P
    (2, 3, 40, 36, 2, (0,) * 5, 0, "tma"),
    (2, 4, 24, 256, 4, (0,) * 5, 0, "tma"),
    (3, 5, 7, 8, 4, (0,) * 5, 0, "tma"),
    (1, 1, 1, 4, 4, (0,) * 5, 0, "tma"),
])
def test_ssd_update_route(b, h, p, n, esize, offs, pad, want):
    """The wrapper's pure route function: every shape the models decode
    takes the TMA route when the state and h' are 16-byte aligned and x,
    b and c come in 4-byte copies; N % 4 != 0, N > 256 or an address or
    stride the copies do not take goes to the scalar one."""
    ptrs, strides = _decode_row(b, h, p, n, esize, offs=offs, pad=pad)
    plan = su.route(b, h, p, n, ptrs, strides, esize)
    assert plan.route == want
    _check_plan(plan, b, h, p, n, esize)


@pytest.mark.parametrize("b,h,p,n", [(4, 64, 64, 128), (128, 64, 64, 128),
                                     (4, 80, 64, 64), (128, 80, 64, 64)])
def test_ssd_update_full_width_plans_keep_every_lane_busy(b, h, p, n):
    """At the models' widths a unit is whole passes of the block's rows
    (16 rows a pass at N = 64, 8 at N = 128) and P is whole units, so no
    lane idles. A unit has 16 KB of state; at batch 4 Zamba2's units are
    halved to 8 KB, which still fit one wave of the card (132 SMs times
    MIN_BLOCKS), so every byte of the state is in flight at once."""
    plan = su.route(b, h, p, n, *_decode_row(b, h, p, n, 2), 2, sms=132)
    pass_rows = su.THREADS // su.lanes_per_row(n)
    assert pass_rows == {64: 16, 128: 8}[n]
    assert plan.unit_rows % pass_rows == 0 and p % plan.unit_rows == 0
    assert plan.unit_rows * n * 4 == (8192 if (b, n) == (4, 64) else 16384)
    units = b * h * (p // plan.unit_rows)
    assert (units <= 132 * su.MIN_BLOCKS) == (b == 4)


@pytest.mark.parametrize("name,kernel_name", [
    ("THREADS", "kThreads"), ("MIN_BLOCKS", "kMinBlocks"),
    ("MAX_PASSES", "kMaxPasses"), ("MAX_UNIT_ROWS", "kMaxUnitRows"),
    ("TMA_MAX_N", "kTmaMaxN"), ("SCALAR_MAX_N", "kMaxN")])
def test_ssd_update_limits_are_the_kernels(name, kernel_name):
    """The limits ``route`` sizes its plans by are the ones the kernel
    checks: each constant equals its ``constexpr`` in the CUDA source."""
    src = (build.CSRC / "ssd_update.cu").read_text()
    found = re.findall(rf"constexpr int {kernel_name} = (\d+);", src)
    assert found == [str(getattr(su, name))]


# the widths 132, 140 and 148 give an odd 16 KB unit (31, 29, 27 rows)
@pytest.mark.parametrize("n", [1, 3, 4, 8, 36, 64, 128, 130, 132, 140, 148,
                               256, 260, 1000, 6144])
@pytest.mark.parametrize("b,h,p", [(1, 1, 1), (2, 3, 40), (4, 64, 64),
                                   (128, 80, 64), (1, 2, 1000), (2, 3, 50)])
def test_ssd_update_plans_fit_the_card(b, h, p, n):
    """Every route's plan, at any width the kernel takes, for fp32 and
    bf16 x and on cards of other SM counts, is one the kernel accepts and
    fits the shared memory of a block (227 KB) and of an SM."""
    for sms, esize in itertools.product((1, 114, 132), (2, 4)):
        for offs in ((0,) * 5, (4,) * 5):
            ptrs, strides = _decode_row(b, h, p, n, esize, offs=offs)
            _check_plan(su.route(b, h, p, n, ptrs, strides, esize, sms),
                        b, h, p, n, esize, sms)


# ---------------------------------------------------------------------------
# grouped_matmul
# ---------------------------------------------------------------------------


def _gmm_inputs(lead, g, k, n, seed=0, bias=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=tuple(lead) + (g * k,)).astype(np.float32)
    w = rng.normal(size=(g, k, n)).astype(np.float32)
    b = rng.normal(size=(g, n)).astype(np.float32) if bias else None
    return x, w, b


# the reference's shapes (K, N and M off the TPU kernel's 128 tiles, so
# ops.grouped_matmul pads) and the reduced serve's Fed2 unembedding
@pytest.mark.parametrize("m,g,k,n", [(64, 4, 32, 48), (200, 5, 100, 70),
                                     (1, 10, 52, 4), (130, 13, 13, 13),
                                     (3, 4, 64, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_matches_reference(m, g, k, n, dtype):
    tdt, jdt = DTYPES[dtype]
    x, w, b = _gmm_inputs((m,), g, k, n)
    before = gm.grouped_matmul.launches
    got = gm.grouped_matmul(_t(x, tdt), _t(w, tdt), _t(b, tdt))
    assert gm.grouped_matmul.launches == before   # CPU: the plain version
    assert got.dtype == tdt and got.shape == (m, g * n)
    xj, wj, bj = (jnp.asarray(a).astype(jdt) for a in (x, w, b))
    tol = 1e-4 if dtype == "float32" else 0.3
    for want in (ref.grouped_matmul_ref(xj, wj, bj),
                 ops.grouped_matmul(xj, wj, bj)):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   atol=tol * np.sqrt(k), rtol=tol)


def test_grouped_matmul_leading_dims_and_no_bias():
    x, w, _ = _gmm_inputs((3, 5), 4, 16, 8, seed=1, bias=False)
    got = gm.grouped_matmul(torch.tensor(x), torch.tensor(w))
    assert got.shape == (3, 5, 32)
    for want in (ref.grouped_matmul_ref(jnp.asarray(x), jnp.asarray(w)),
                 ops.grouped_matmul(jnp.asarray(x), jnp.asarray(w))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4 * 4, rtol=1e-4)


def test_grouped_dense_apply_kernel_route_matches_einsum():
    """``use_kernel=True`` on CPU tensors takes the kernel's plain
    version: the same function as the einsum route, bias included."""
    x, w, b = _gmm_inputs((2, 3), 4, 8, 6, seed=2)
    p = {"w": torch.tensor(w), "b": torch.tensor(b)}
    on = grouped_dense_apply(p, torch.tensor(x), use_kernel=True)
    off = grouped_dense_apply(p, torch.tensor(x))
    np.testing.assert_allclose(on.numpy(), off.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_grouped_matmul_rejects_bad_inputs():
    x, w, b = (torch.tensor(a) for a in _gmm_inputs((4,), 2, 8, 6))
    with pytest.raises(ValueError):                   # x of the wrong width
        gm.grouped_matmul(x[:, :15], w)
    with pytest.raises(ValueError):                   # bias not (G, N)
        gm.grouped_matmul(x, w, b[:, :5])
    with pytest.raises(TypeError):                    # dtypes differ
        gm.grouped_matmul(x, w.bfloat16())
    with pytest.raises(ValueError):                   # strided x
        gm.grouped_matmul(torch.zeros(16, 4).t(), w)


def test_grouped_matmul_refuses_autograd():
    """The kernel's output carries no grad_fn, so on CUDA tensors the
    wrapper raises when autograd records the call (``check_no_autograd``,
    which it calls before launching) rather than return a detached
    result; under no_grad, or on inputs that need no grad, it passes.
    The CPU route is the differentiable plain version."""
    x, w, b = (torch.tensor(a) for a in _gmm_inputs((4,), 2, 8, 6))
    for args in ((x.clone().requires_grad_(), w, None),
                 (x, w.clone().requires_grad_(), b),
                 (x, w, b.clone().requires_grad_())):
        with pytest.raises(RuntimeError, match="no backward"):
            gm.check_no_autograd(*args)
        with torch.no_grad():
            gm.check_no_autograd(*args)
    gm.check_no_autograd(x, w, b)
    xg = x.clone().requires_grad_()
    gm.grouped_matmul(xg, w, b).sum().backward()
    assert xg.grad is not None and bool(xg.grad.abs().sum() > 0)
