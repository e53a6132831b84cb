"""Fed2's feature interpretation in the port (``repro_torch.core.
feature_stats``, ``kernels/feature_stats.py``, the grouping helpers and
``launch/auto_depth.py``) against the reference's, on the same numpy
inputs and converted parameters.

Tolerances:
- ``feature_stats_ref`` vs the reference's oracle: 1e-4 absolute at
  sums of up to 256 products of O(1) values (fp32, another summation
  order). bf16 inputs are rounded identically on both sides and
  multiplied in fp32, so bf16 is held to the same figure.
- ``feature_stats_many_ref`` vs the same oracle, instance by instance:
  fp32 at 1e-4; bf16 at the JAX kernel test's atol 0.2 / rtol 1e-2.
- Eq. 9's batched route vs the port's per-class plain route, on the
  CPU: 1e-6 absolute (one fp32 sum of the same products per column).
- class preference vectors (Eq. 9), port under both kernel flags vs the
  reference under ``use_kernel=True`` (its Pallas kernel in interpret
  mode): 1e-4 absolute (measured below 1e-6), inside the JAX test's
  own 1e-3 between its two routes.
- the auto-depth workflow: the same TV profile (1e-4 relative) and
  chosen depth, accuracies within one eval example, and final
  parameters within 1e-4 or, if larger, twice what a one-ulp change of
  the initial parameters does to the port's own run. After one round the
  port and the reference agree to 1.2e-7; the second round's 8 local
  steps amplify round-off of any origin to about 1.2e-4 (measured: port
  vs reference 1.22e-4, port vs port from an init moved by one ulp
  1.21e-4), so a fixed 1e-4 would test this run's conditioning, not
  the port.
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
from repro.configs import vgg16 as jvgg16
from repro.core import feature_stats as jfs
from repro.core import grouping as jgrouping
from repro.data import synthetic as jdata
from repro.fl import runtime as jruntime
from repro.kernels import ref as jref
from repro.models import cnn as jcnn
from repro.optim.optimizers import sgd as jsgd
from repro_torch import convert
from repro_torch.core import feature_stats as tfs
from repro_torch.core import fusion as tfusion
from repro_torch.core import grouping as tgrouping
from repro_torch.kernels import feature_stats as kfs
from repro_torch.kernels import paired_fusion as pf
from repro_torch.launch import auto_depth
from repro_torch.models import cnn as tcnn
from repro_torch.models.module import tree_leaves, tree_map

TOL = 1e-4


def _jax_cfg(tcfg):
    """The reference's CNNConfig with the port config's fields."""
    return jcnn.CNNConfig(**{f.name: getattr(tcfg, f.name)
                             for f in dataclasses.fields(tcfg)
                             if f.name != "dtype"})


def _jax_init_np(jcfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jcnn.init_cnn(jax.random.PRNGKey(seed), jcfg))


# ---------------------------------------------------------------------------
# the kernel's plain version and the wrapper's input checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,i", [(32, 100), (256, 512), (100, 1000), (7, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_feature_stats_ref_matches_reference(b, i, dtype):
    rng = np.random.default_rng(b * 7 + i)
    a = rng.normal(size=(b, i)).astype(np.float32)
    g = rng.normal(size=(b, i)).astype(np.float32)
    tdt = getattr(torch, dtype)
    ta, tg = torch.tensor(a).to(tdt), torch.tensor(g).to(tdt)
    want = jref.feature_stats_ref(jnp.asarray(a).astype(dtype),
                                  jnp.asarray(g).astype(dtype))
    before = kfs.feature_stats.launches
    got = kfs.feature_stats(ta, tg)           # CPU: the plain version
    assert kfs.feature_stats.launches == before
    assert got.dtype == torch.float32 and got.shape == (i,)
    torch.testing.assert_close(got, kfs.feature_stats_ref(ta, tg),
                               atol=0, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_feature_stats_rejects_bad_inputs():
    x = torch.zeros(4, 6)
    with pytest.raises(ValueError, match="one shape"):
        kfs.feature_stats(x, torch.zeros(4, 5))
    with pytest.raises(ValueError, match="one shape"):
        kfs.feature_stats(x.reshape(2, 2, 6), x.reshape(2, 2, 6))
    with pytest.raises(ValueError, match="non-empty"):
        kfs.feature_stats(torch.zeros(0, 6), torch.zeros(0, 6))
    with pytest.raises(TypeError):
        kfs.feature_stats(x.double(), x.double())
    with pytest.raises(TypeError):
        kfs.feature_stats(x, x.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        kfs.feature_stats(torch.zeros(6, 4).t(), x)
    m = torch.zeros(4, 6, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kfs.feature_stats(m, m)
    with pytest.raises(ValueError, match="share a device"):
        kfs.feature_stats(x, m)


# ---------------------------------------------------------------------------
# the batched call: many (S, B, I) segments, one launch on the card
# ---------------------------------------------------------------------------

# the auto-depth path's tapped widths (vgg9.baseline(): 6 convs, 2 FCs)
AUTO_DEPTH_WIDTHS = (32, 64, 128, 128, 256, 256, 512, 512)
MANY_TABLES = {     # name -> [(S, B, I), ...]
    "auto_depth": [(10, 64, i) for i in AUTO_DEPTH_WIDTHS],
    "odd_s1": [(1, 7, 3), (1, 100, 1000)],
    "odd_s3": [(3, 7, 3), (3, 100, 1000)],
}


def _segments(shapes, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s).astype(np.float32),
             rng.normal(size=s).astype(np.float32)) for s in shapes]


@pytest.mark.parametrize("table", sorted(MANY_TABLES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_feature_stats_many_ref_matches_reference(table, dtype):
    """Each instance of each segment against the reference's oracle: fp32
    at 1e-4, bf16 at the JAX kernel test's bounds (atol 0.2, rtol 1e-2;
    tests/test_kernels.py)."""
    shapes = MANY_TABLES[table]
    segs = _segments(shapes, seed=len(table) * 31 + len(dtype))
    tdt = getattr(torch, dtype)
    a_t = [torch.tensor(a).to(tdt) for a, _ in segs]
    g_t = [torch.tensor(g).to(tdt) for _, g in segs]
    before = kfs.feature_stats.launches
    got = kfs.feature_stats_many(a_t, g_t)     # CPU: the plain version
    assert kfs.feature_stats.launches == before
    tol = ({"atol": TOL, "rtol": 0} if dtype == "float32"
           else {"atol": 2e-1, "rtol": 1e-2})
    for (a, g), p, (s, _, i) in zip(segs, got, shapes):
        assert p.dtype == torch.float32 and p.shape == (i, s)
        for k in range(s):
            want = jref.feature_stats_ref(jnp.asarray(a[k]).astype(dtype),
                                          jnp.asarray(g[k]).astype(dtype))
            np.testing.assert_allclose(p[:, k].numpy(), np.asarray(want),
                                       **tol)
    for p, a, g in zip(got, a_t, g_t):      # instance k = feature_stats
        for k in range(a.shape[0]):
            torch.testing.assert_close(p[:, k],
                                       kfs.feature_stats(a[k], g[k]),
                                       atol=0, rtol=0)


def test_feature_stats_many_writes_strided_outs():
    """``outs`` may be strided (I, S) views: the results land in them (and
    nowhere else) and the same tensors come back."""
    segs = _segments([(4, 5, 6), (4, 3, 2)], seed=2)
    a_t = [torch.tensor(a) for a, _ in segs]
    g_t = [torch.tensor(g) for _, g in segs]
    big = torch.full((6, 9), -7.0)
    outs = [big[:, 1:9:2], torch.full((4, 2), -7.0).t()]
    got = kfs.feature_stats_many(a_t, g_t, outs=outs)
    assert got[0] is outs[0] and got[1] is outs[1]
    want = kfs.feature_stats_many_ref(a_t, g_t)
    for o, w in zip(outs, want):
        torch.testing.assert_close(o, w, atol=0, rtol=0)
    assert bool((big[:, 0::2] == -7.0).all())      # untouched columns


def test_feature_stats_many_rejects_bad_inputs():
    x = torch.zeros(2, 4, 6)
    with pytest.raises(ValueError, match="one or more"):
        kfs.feature_stats_many([], [])
    with pytest.raises(ValueError, match="one or more"):
        kfs.feature_stats_many([x, x], [x])
    with pytest.raises(ValueError, match="one shape"):
        kfs.feature_stats_many([x], [torch.zeros(2, 4, 5)])
    with pytest.raises(ValueError, match="one shape"):
        kfs.feature_stats_many([x[0]], [x[0]])
    with pytest.raises(ValueError, match="empty"):
        kfs.feature_stats_many([torch.zeros(0, 4, 6)], [torch.zeros(0, 4, 6)])
    with pytest.raises(TypeError):
        kfs.feature_stats_many([x, x.bfloat16()], [x, x.bfloat16()])
    with pytest.raises(TypeError):
        kfs.feature_stats_many([x], [x.bfloat16()])
    with pytest.raises(TypeError):
        kfs.feature_stats_many([x.double()], [x.double()])
    m = torch.zeros(2, 4, 6, device="meta")
    with pytest.raises(ValueError, match="share a device"):
        kfs.feature_stats_many([x, m], [x, m])
    with pytest.raises(ValueError, match="unsupported device"):
        kfs.feature_stats_many([m], [m])
    with pytest.raises(ValueError, match="contiguous"):
        kfs.feature_stats_many([torch.zeros(2, 6, 4).transpose(1, 2)], [x])
    with pytest.raises(ValueError, match="outs for"):
        kfs.feature_stats_many([x], [x], outs=[])
    for bad in (torch.zeros(2, 6), torch.zeros(6, 2, dtype=torch.float64),
                torch.zeros(6, 3)):
        with pytest.raises(ValueError, match=r"\(I, S\)"):
            kfs.feature_stats_many([x], [x], outs=[bad])
    with pytest.raises(ValueError, match="overlaps"):
        kfs.feature_stats_many([x], [x],
                               outs=[torch.zeros(6, 1).expand(6, 2)])


class _FakeCuda:
    """Shape, dtype and device of a contiguous CUDA tensor and no memory:
    enough for the wrapper's checks, which come before the build."""

    def __init__(self, *shape):
        self.shape, self.dtype = torch.Size(shape), torch.float32
        self.device = torch.device("cuda", 0)

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True


def test_feature_stats_many_raises_when_the_build_fails(monkeypatch):
    """No fallback: on CUDA tensors a failed build raises and counts no
    launch."""
    from repro_torch.kernels import build

    def no_nvcc(name):
        raise RuntimeError(f"nvcc failed building {name}")

    monkeypatch.setattr(build, "load", no_nvcc)
    before = kfs.feature_stats.launches
    t = _FakeCuda(2, 4, 8)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kfs.feature_stats_many([t], [t])
    assert kfs.feature_stats.launches == before


def _narrow_vgg16():
    """VGG16's 13 convs and 2 hidden FCs at a sixteenth of the width, on
    100 classes: the Eq. 9 table of vgg16 (100 x 15 reductions) at a size
    the CPU runs in seconds."""
    from repro_torch.configs import vgg16
    plan = tuple(s if s[0] == "p" else ("c", s[1] // 16)
                 for s in tcnn.VGG16_PLAN)
    return dataclasses.replace(vgg16.baseline(), plan=plan, fc_dims=(32, 32))


@pytest.mark.parametrize("name", ["vgg9", "vgg16"])
def test_class_preference_vectors_kernel_route_matches_plain(name):
    """The batched route (one feature_stats_many call) against the plain
    per-class route of the port, on the CPU: no launch, within 1e-6."""
    from repro_torch.configs import vgg9
    cfg = (vgg9.reduced(fed2_groups=0, norm="none") if name == "vgg9"
           else _narrow_vgg16())
    n_taps = 15 if name == "vgg16" else 4
    p = tcnn.init_cnn(torch.Generator().manual_seed(2), cfg)
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.normal(size=(16, 32, 32, 3)).astype(np.float32))
    y = torch.tensor(rng.integers(0, cfg.n_classes, 16))
    before = kfs.feature_stats.launches
    on = tfs.class_preference_vectors(p, cfg, x, y, use_kernel=True)
    assert kfs.feature_stats.launches == before
    off = tfs.class_preference_vectors(p, cfg, x, y, use_kernel=False)
    assert len(on) == len(off) == n_taps
    for a, b in zip(on, off):
        assert a.shape == b.shape and a.shape[1] == cfg.n_classes
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    assert any(bool((b != 0).any()) for b in off)


# ---------------------------------------------------------------------------
# Eq. 9 preference vectors on the three CNN families
# ---------------------------------------------------------------------------

FAMILIES = {
    "vgg9_plain": jvgg9.reduced(fed2_groups=0, norm="none"),
    "vgg9_grouped": jvgg9.reduced(),
    "vgg16_plain": jvgg16.reduced(fed2_groups=0, norm="none"),
    "vgg16_grouped": jvgg16.reduced(),
    "mobilenet_plain": jmobilenet.reduced(fed2_groups=0, norm="none"),
    "mobilenet_grouped": jmobilenet.reduced(),
}


def _probe(n=12):
    rng = np.random.default_rng(5)
    return (rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
            (np.arange(n) % 10).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _reference_pvecs(name):
    """The reference's Eq. 9 on its Pallas route (interpret mode) and
    its init (numpy); the port's two routes share it."""
    jcfg = FAMILIES[name]
    pn = _jax_init_np(jcfg, seed=1)
    x, y = _probe()
    pv = jfs.class_preference_vectors(pn, jcfg, jnp.asarray(x),
                                      jnp.asarray(y), use_kernel=True)
    return [np.asarray(p) for p in pv], pn


def _port_cfg(name):
    from repro_torch.configs import mobilenet, vgg9, vgg16
    mod = {"vgg9": vgg9, "vgg16": vgg16, "mobilenet": mobilenet}[
        name.split("_")[0]]
    if name.endswith("plain"):
        return mod.reduced(fed2_groups=0, norm="none")
    return mod.reduced()


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_class_preference_vectors_match_reference(name, use_kernel):
    want, pn = _reference_pvecs(name)
    x, y = _probe()
    before = kfs.feature_stats.launches
    got = tfs.class_preference_vectors(
        convert.to_port(pn), _port_cfg(name), torch.tensor(x),
        torch.tensor(y), use_kernel=use_kernel)
    assert kfs.feature_stats.launches == before   # CPU: plain version
    assert len(got) == len(want)
    metas = [m for m in tcnn.layer_meta(_port_cfg(name))
             if m.kind in ("c", "dw", "fc")]
    for g, w, m in zip(got, want, metas):
        assert g.shape == w.shape == (m.c_out, 10)
        np.testing.assert_allclose(g.numpy(), w, atol=TOL)
    tvs = [float(tfs.total_variance(p)) for p in got]
    np.testing.assert_allclose(
        tvs, [float(jfs.total_variance(jnp.asarray(w))) for w in want],
        rtol=1e-4, atol=1e-7)


def test_taps_apply_no_pan_and_offsets_add_after_relu():
    """The taps forward mirrors the reference: no PAN encoding even when
    the config has one, and an offset shifts the tap itself (taken after
    the ReLU), so the tap may go negative."""
    tcfg = _port_cfg("vgg9_plain")
    pan = dataclasses.replace(tcfg, pan=0.5)
    p = tcnn.init_cnn(torch.Generator().manual_seed(0), tcfg)
    x = torch.tensor(_probe(4)[0])
    la, ta = tfs.apply_cnn_with_taps(p, tcfg, x)
    lb, tb = tfs.apply_cnn_with_taps(p, pan, x)
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(ta, tb))
    offs = [torch.full_like(t, -1.0) for t in ta]
    _, tc = tfs.apply_cnn_with_taps(p, tcfg, x, offs)
    torch.testing.assert_close(tc[0], ta[0] - 1.0)


# ---------------------------------------------------------------------------
# Eq. 17, the depth rule and the alignment score
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tvs,frac,min_shared", [
    ([0.1, 0.2, 0.9, 1.0, 0.8], 0.5, 2),
    ([0.1, 0.2, 0.9, 1.0, 0.8], 0.5, 4),
    ([1.0, 0.1, 0.1, 0.1], 0.5, 2),
    ([0.3, 0.3, 0.3], 0.5, 0),
    ([0.0, 0.0, 0.0], 0.5, 1),
    ([], 0.5, 2),
    ([0.2, 0.4, 0.6, 0.8, 1.0, 1.2, 1.4, 1.6], 0.7, 2),
])
def test_choose_decouple_depth_matches_reference(tvs, frac, min_shared):
    assert (tgrouping.choose_decouple_depth(tvs, threshold_frac=frac,
                                            min_shared=min_shared)
            == jgrouping.choose_decouple_depth(tvs, threshold_frac=frac,
                                               min_shared=min_shared))


def test_total_variance_primary_class_alignment_match_reference():
    rng = np.random.default_rng(11)
    nodes = [rng.normal(size=(24, 10)).astype(np.float32) for _ in range(4)]
    nodes[1][:12] = nodes[0][:12]              # some agreement
    for pv in nodes:
        np.testing.assert_allclose(
            float(tfs.total_variance(torch.tensor(pv))),
            float(jfs.total_variance(jnp.asarray(pv))), rtol=1e-6)
        np.testing.assert_array_equal(
            tfs.primary_class(torch.tensor(pv)).numpy(),
            np.asarray(jfs.primary_class(jnp.asarray(pv))))
    got = tfs.feature_alignment_score([torch.tensor(p) for p in nodes])
    want = jfs.feature_alignment_score([jnp.asarray(p) for p in nodes])
    assert got == pytest.approx(want, abs=1e-7)
    assert tfs.feature_alignment_score([torch.tensor(nodes[0])] * 3) == 1.0


# ---------------------------------------------------------------------------
# Eq. 16: gradient redirection on the port's grouped VGG16 and MobileNet
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["vgg16", "mobilenet"])
def test_gradient_redirection_isolation(family):
    """In the decoupled layers, the gradient of class c's logit with
    respect to group g's parameters is exactly zero unless c is
    allocated to g (the reference's tests/test_fed2_core.py check, on
    every grouped weight leaf: convs, depthwise and pointwise blocks,
    FCs and logits)."""
    from repro_torch.configs import mobilenet, vgg16
    mod = {"vgg16": vgg16, "mobilenet": mobilenet}[family]
    cfg = mod.reduced(fed2_groups=5, decouple=3, norm="none")
    p = tcnn.init_cnn(torch.Generator().manual_seed(0), cfg)
    p = tree_map(lambda t: t.requires_grad_(True), p)
    axes = tfusion.cnn_group_axes(p, cfg)
    from repro_torch.models.module import tree_get, tree_paths
    grouped = [path for path in tree_paths(p)
               if path[-1] == "w" and tree_get(axes, path) is not None]
    assert len(grouped) >= 3
    x = torch.tensor(_probe(5)[0])
    spec = tgrouping.GroupSpec.contiguous(5, 10)
    for c in (0, 3, 9):
        own = spec.group_of_class(c)
        logits = tcnn.apply_cnn(p, cfg, x)
        leaves = [tree_get(p, path) for path in grouped]
        grads = torch.autograd.grad(logits[:, c].sum(), leaves)
        for path, gr in zip(grouped, grads):
            blocks = gr.reshape(5, -1).abs().sum(1)
            for g in range(5):
                if g == own:
                    assert blocks[g] > 0, (c, path, g)
                else:
                    assert blocks[g] == 0, (c, path, g, float(blocks[g]))


# ---------------------------------------------------------------------------
# the auto-depth workflow against the same steps composed in JAX
# ---------------------------------------------------------------------------

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
