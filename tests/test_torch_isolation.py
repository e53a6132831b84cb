"""Port hygiene: ``repro_torch`` stands alone and never falls back.

- importing every module of the port (in a fresh interpreter) leaves jax
  and the reference package ``repro`` out of ``sys.modules``;
- no source file of the port, nor ``chip_smoke.py``, holds an import
  statement of jax or of ``repro``;
- with no CUDA card, the entry points raise unless the caller names a
  device: nothing moves to the CPU silently;
- a kernel wrapper takes its plain version only for CPU tensors.
"""
import math
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
IMPORT_RE = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)(?:[.\s,]|$)",
                       re.M)

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
"""


def test_importing_the_port_loads_neither_jax_nor_repro():
    out = subprocess.run([sys.executable, "-c", _PROBE], check=True,
                         capture_output=True, text=True,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")})
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 20, out.stdout          # every module was imported
    assert bad == "[]", bad


# the dry-run surfaces and the examples, each its own module of the
# package (so the import probe above walks them)
SURFACES = ("configs.shapes", "launch.analytic", "launch.mesh",
            "launch.sharding", "launch.dryrun", "examples.quickstart",
            "examples.fed2_cifar_fl", "examples.llm_federated_finetune",
            "examples.serve_decode")


def test_the_surfaces_are_modules_of_the_port():
    import pkgutil

    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {f"repro_torch.{s}" for s in SURFACES} <= names


def test_regex_tells_the_port_from_the_reference():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import x",
                 "from repro.fl import runtime", "import repro",
                 "    from repro.kernels import ops"):
        assert IMPORT_RE.search(line), line
    for line in ("import repro_torch", "from repro_torch.fl import engine",
                 "import jaxtyping", "# we never import jax here"):
        assert not IMPORT_RE.search(line), line


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_jax_or_reference_import_statement(path):
    src = (ROOT / path).read_text()
    assert not IMPORT_RE.findall(src), path


def test_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.fl import runtime, scenarios
    from repro_torch.launch import auto_depth, serve, train
    from repro_torch.launch import scenarios as launch_scenarios
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.resolve_device(None)
    spec = scenarios.get("nxc2_fed2").override(rounds=1, train_size=60,
                                               test_size=20)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.run_federated(
            runtime.cnn_task(spec.model_config()), spec.fl_config(),
            [[0]] * spec.population, lambda s: {}, [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scenarios.run_scenario(spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--rounds", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_scenarios.main(["--scenarios", "nxc2_fed2", "--rounds", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        auto_depth.main(["--reduced"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        auto_depth.run_auto_depth(reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--gen", "1", "--prompt-len", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run_serve(get_config("mamba2-1.3b", reduced=True), gen=1,
                        prompt_len=1)
    from repro_torch.examples import (fed2_cifar_fl, llm_federated_finetune,
                                      quickstart, serve_decode)
    for example in (quickstart, fed2_cifar_fl, llm_federated_finetune,
                    serve_decode):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            example.main([])
    assert runtime.resolve_device("cpu") == torch.device("cpu")


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    from repro_torch.kernels.feature_stats import feature_stats
    from repro_torch.kernels.grouped_matmul import grouped_matmul
    from repro_torch.kernels.local_step import local_step
    from repro_torch.kernels.paired_fusion import paired_fusion
    from repro_torch.kernels.ssd_update import ssd_update
    x = torch.zeros(3, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        paired_fusion(x, torch.ones(3, device="meta") / 3)
    with pytest.raises(ValueError, match="unsupported device"):
        local_step(x, x, x, lr=0.1, mu=0.9)
    with pytest.raises(ValueError, match="unsupported device"):
        feature_stats(x, x)
    with pytest.raises(ValueError, match="unsupported device"):
        grouped_matmul(x, torch.zeros(2, 4, 5, device="meta"))
    h, v = (torch.zeros(s, device="meta") for s in ((2, 3, 4, 8), (3,)))
    with pytest.raises(ValueError, match="unsupported device"):
        ssd_update(h, torch.zeros(2, 3, 4, device="meta"),
                   torch.zeros(2, 3, device="meta"), v,
                   torch.zeros(2, 8, device="meta"),
                   torch.zeros(2, 8, device="meta"), v)


class FakeCuda:
    """Shape, dtype, device and contiguous strides of a CUDA tensor, and
    no memory: enough for a wrapper's checks, which come before any
    device memory is touched."""

    def __init__(self, *shape, dtype=torch.float32, ptr=0,
                 requires_grad=False):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.device = torch.device("cuda", 0)
        self.ptr = ptr
        self.requires_grad = requires_grad

    def data_ptr(self):
        return self.ptr

    def dim(self):
        return len(self.shape)

    def numel(self):
        return math.prod(self.shape)

    def is_contiguous(self):
        return True

    def stride(self, i):
        return math.prod(self.shape[i + 1:])


def _no_nvcc(name):
    raise RuntimeError(f"nvcc failed building {name}")


def test_cuda_wrappers_raise_when_the_build_fails(monkeypatch):
    """No fallback: on a CUDA tensor a failed kernel build raises; it
    never turns into the plain version. (The tensor is faked: the check
    comes before any device memory is touched.)"""
    from repro_torch.kernels import build
    from repro_torch.kernels import feature_stats as fs

    monkeypatch.setattr(build, "load", _no_nvcc)
    before = fs.feature_stats.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fs.feature_stats(FakeCuda(4, 8), FakeCuda(4, 8))
    assert fs.feature_stats.launches == before


@pytest.mark.parametrize("kernel", ["grouped_matmul", "ssd_update"])
def test_serving_kernels_raise_when_the_build_fails(monkeypatch, kernel):
    """The same for the serving path's two kernels."""
    import importlib

    from repro_torch.kernels import build
    mod = importlib.import_module(f"repro_torch.kernels.{kernel}")
    wrapper = getattr(mod, kernel)
    args = {"grouped_matmul": (FakeCuda(4, 16), FakeCuda(2, 8, 5)),
            "ssd_update": (FakeCuda(2, 3, 4, 8), FakeCuda(2, 3, 4),
                           FakeCuda(2, 3), FakeCuda(3), FakeCuda(2, 8),
                           FakeCuda(2, 8), FakeCuda(3))}[kernel]
    monkeypatch.setattr(build, "load", _no_nvcc)
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        wrapper(*args)
    assert wrapper.launches == before


# the serve path's Fed2 unembedding (G = 8, K = 256, N = 6288) at
# decode batches, and the shapes and pointers that take each route
_GMM_FULL = (8, 256, 6288)


@pytest.mark.parametrize("m,g,k,n,dtype,x_off,w_off,want", [
    (4, *_GMM_FULL, torch.bfloat16, 0, 0, "stream"),
    (8, *_GMM_FULL, torch.bfloat16, 0, 0, "stream"),
    (1, *_GMM_FULL, torch.bfloat16, 0, 0, "stream"),
    (4, *_GMM_FULL, torch.float32, 0, 0, "stream"),
    (9, *_GMM_FULL, torch.bfloat16, 0, 0, "wgmma"),
    (128, *_GMM_FULL, torch.bfloat16, 0, 0, "wgmma"),
    (128, *_GMM_FULL, torch.float32, 0, 0, "sgemm"),
    (4, 8, 256, 6289, torch.bfloat16, 0, 0, "simt"),    # N off 16 bytes
    (128, 8, 256, 6289, torch.bfloat16, 0, 0, "simt"),
    (4, 8, 256, 6292, torch.float32, 0, 0, "stream"),   # fp32: 16 bytes
    (4, 2, 100, 264, torch.bfloat16, 0, 0, "simt"),     # K off 16 bytes
    (64, 2, 100, 264, torch.bfloat16, 0, 0, "simt"),
    (4, 2, 104, 264, torch.bfloat16, 0, 0, "stream"),
    (64, 3, 104, 200, torch.bfloat16, 0, 0, "wgmma"),
    (4, 2, 100, 68, torch.float32, 0, 0, "stream"),
    (4, *_GMM_FULL, torch.bfloat16, 0, 2, "simt"),      # w one element off
    (128, *_GMM_FULL, torch.bfloat16, 0, 2, "simt"),
    (4, *_GMM_FULL, torch.float32, 0, 4, "simt"),
    (4, *_GMM_FULL, torch.bfloat16, 2, 0, "simt"),      # x one element off
    (128, *_GMM_FULL, torch.bfloat16, 16, 16, "wgmma"),
    # the fp32 LM rounds' evals (Mamba-2's and Llama's unembedding at 4
    # groups): M = 9 (the first row past the stream route), 128, and the
    # eval's 64 x 64 tokens
    *((m, 4, 512, n, torch.float32, 0, 0, "sgemm")
      for n in (12576, 32064) for m in (9, 128, 4096)),
    (8, 4, 512, 12576, torch.float32, 0, 0, "stream"),
    (128, 2, 100, 264, torch.float32, 0, 0, "sgemm"),   # fp32: 400 bytes
    (128, 2, 102, 264, torch.float32, 0, 0, "simt"),    # K off 16 bytes
    (128, 8, 256, 6289, torch.float32, 0, 0, "simt"),   # N off 16 bytes
    (128, *_GMM_FULL, torch.float32, 0, 4, "simt"),     # w one element off
    (128, *_GMM_FULL, torch.float32, 4, 0, "simt"),     # x one element off
    (4096, 4, 512, 32064, torch.float32, 16, 32, "sgemm"),
])
def test_grouped_matmul_route(m, g, k, n, dtype, x_off, w_off, want):
    """The wrapper's pure route function: M <= 8 streams, M > 8 runs
    wgmma in bf16 and sgemm in fp32, and whatever TMA does not take (K
    or N off 16 bytes, a base off 16 bytes) takes the simt tiles."""
    from repro_torch.kernels import grouped_matmul as gm
    base = 1 << 20
    assert gm.route(m, g, k, n, dtype, base + x_off, base + w_off) == want


@pytest.mark.parametrize("m,k,n,dtype,route", [
    (4, 256, 6288, torch.bfloat16, "stream"),
    (128, 256, 6288, torch.bfloat16, "wgmma"),
    (128, 256, 6288, torch.float32, "sgemm"),
    (4, 256, 6289, torch.bfloat16, "simt"),
    (128, 256, 6289, torch.float32, "simt"),
    # a long-K product: 64-column units on the stream route, K split over
    # a cluster on the wgmma route
    (4, 4096, 256, torch.bfloat16, "stream"),
    (128, 4096, 256, torch.bfloat16, "wgmma")])
def test_grouped_matmul_raises_on_every_route_when_the_build_fails(
        monkeypatch, m, k, n, dtype, route):
    """No route or plan falls back: with the build failing, a CUDA call
    of each route's shape (and of a split plan's) raises and counts no
    launch, in total or by route."""
    from repro_torch.kernels import build
    from repro_torch.kernels import grouped_matmul as gm
    x = FakeCuda(m, 8 * k, dtype=dtype, ptr=1 << 20)
    w = FakeCuda(8, k, n, dtype=dtype, ptr=1 << 21)
    assert gm.route(m, 8, k, n, dtype, x.data_ptr(), w.data_ptr()) == route
    assert gm.plan(route, m, 8, k, n, 132, dtype)[0] == (
        2 if k > 256 and route == "wgmma" else 1)
    monkeypatch.setattr(build, "load", _no_nvcc)
    before = (gm.grouped_matmul.launches,
              dict(gm.grouped_matmul.route_launches))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        gm.grouped_matmul(x, w)
    assert (gm.grouped_matmul.launches,
            gm.grouped_matmul.route_launches) == before
    assert set(gm.grouped_matmul.route_launches) == set(gm.ROUTES)


def test_grouped_matmul_limits_are_the_kernels():
    """The wrapper's route codes and limits are csrc/grouped_matmul.cu's:
    ``ROUTES`` in the order of its ``enum Route``, the stream route's
    rows, the simt and sgemm tiles."""
    from repro_torch.kernels import build
    from repro_torch.kernels import grouped_matmul as gm
    src = (build.CSRC / "grouped_matmul.cu").read_text()
    enum = re.search(r"enum Route \{([^}]*)\}", src).group(1)
    codes = dict(re.findall(r"k(\w+) = (\d+)", enum))
    assert [codes[r.capitalize()] for r in gm.ROUTES] == \
        [str(i) for i in range(len(gm.ROUTES))]
    assert re.search(rf"constexpr int kStreamMaxM = {gm._STREAM_MAX_M};",
                     src)
    assert re.search(rf"using LargeM = Tile<{gm._SIMT_TILE_M}, ", src)
    sg = src[src.index("namespace sg {"):]
    for name, size in zip(("BM", "BN"), gm._SGEMM_TILE):
        assert re.search(rf"constexpr int {name} = {size};", sg)
    # the plans: the largest split, the column widths the kernels were
    # built for (the default one among them), each route's stage of K
    # and the wgmma tile's rows
    assert re.search(rf"constexpr int kMaxSplits = {gm._MAX_SPLITS};", src)
    widths = re.search(r"constexpr bool plan_cols\(int c\) \{ return ([^;]*);",
                       src).group(1)
    assert tuple(int(c) for c in re.findall(r"c == (\d+)", widths)) == \
        gm._PLAN_COLS
    assert re.search(rf"constexpr int kDefaultCols = {gm.DEFAULT_PLAN[1]};",
                     src) and gm.DEFAULT_PLAN[0] == 1
    split = re.search(r"constexpr bool split_cols\(int c\) \{ return ([^;]*);",
                      src).group(1)
    assert tuple(int(c) for c in re.findall(r"c == (\d+)", split)) == \
        gm._SPLIT_COLS
    gemv = src[src.index("namespace gemv {"):]
    assert re.search(rf"constexpr int KR = {gm._STAGE_K['stream']};", gemv)
    mma = src[src.index("namespace mma {"):]
    assert re.search(rf"constexpr int BK = {gm._STAGE_K['wgmma']};", mma)
    assert re.search(rf"constexpr int BM = {gm._WGMMA_TILE_M};", mma)
    # the unsplit wgmma kernel: its widths (256 among them), the pairs of
    # row tiles past one row tile, and its ring beside the y buffers,
    # reckoned from the same constants, within the block's shared memory
    wide = re.search(r"constexpr bool wgmma_cols\(int c\) \{ return ([^;]*);",
                     src).group(1)
    assert wide.startswith("plan_cols(c)") and tuple(
        int(c) for c in re.findall(r"c == (\d+)", wide)) == \
        gm._WGMMA_COLS[len(gm._PLAN_COLS):]
    assert gm._WGMMA_COLS[:len(gm._PLAN_COLS)] == gm._PLAN_COLS
    assert "const bool pairs = m > BM;" in src and re.search(
        rf"pairs \? launch_unsplit<BN, {gm._WGMMA_PAIR}>", src)
    # the unsplit kernel's shared memory, reckoned from the .cu's own
    # constants as its UnsplitLayout reckons it: each width's ring (x's
    # 128 x 64 box and the tile's 64 x 64 w boxes a stage, two 8-byte
    # mbarriers each) beside two 16 x 64 bf16 y chunks a consumer warp,
    # within 232,448 bytes, at least 4 stages, and no stage more would fit
    # below the cap
    def const(name, text=mma):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("kMaxSmem", src) == 232_448
    assert const("kConsumerWarps") == 8
    assert re.search(r"constexpr int kOutChunk = 16 \* 64 \* 2;", mma)
    lay = src[src.index("struct UnsplitLayout {"):]
    assert re.search(r"kStageBytes = mma::kABytes \+ \(BN / 64\) \* "
                     r"mma::kBBox;", lay)
    assert re.search(r"kOutBytes = 2 \* mma::kConsumerWarps \* "
                     r"mma::kOutChunk;", lay)
    assert re.search(r"kFit =\s+\(kMaxSmem - 1024 - kOutBytes\) / "
                     r"\(kStageBytes \+ 16\);", lay)
    assert re.search(r"kStages = kFit < mma::kMaxRing \? kFit : "
                     r"mma::kMaxRing;", lay)
    assert re.search(r"kSmem = 1024 \+ kStages \* \(kStageBytes \+ 16\) \+ "
                     r"kOutBytes;", lay)
    out, cap = 2 * 8 * 16 * 64 * 2, const("kMaxRing")
    stages = []
    for c in gm._WGMMA_COLS:
        stage = 128 * 64 * 2 + (c // 64) * 64 * 64 * 2 + 16
        n = min(cap, (232_448 - 1024 - out) // stage)
        smem = 1024 + n * stage + out
        assert n >= 4 and smem <= 232_448 and (
            n == cap or smem + stage > 232_448)
        stages.append(n)
    assert stages == [8, 6, 4, 4]


# (K, N) of a group for every product the Fed2 decode and eval paths run
# through grouped_matmul (8 groups): the other dense configs' and
# zamba2's (chip_smoke.OTHER_GMM_SHAPES), Whisper's FFN and InternVL's
# unembedding (FRONTEND_GMM_SHAPES), Llama's FFN, the Mamba-2 and MoE
# unembeddings; and two long-K products past the split threshold
_GMM_PLAN_SHAPES = (
    (448, 19008), (448, 2368), (2368, 448), (640, 12544), (640, 1728),
    (1728, 640), (320, 4000), (320, 864), (864, 320),
    (64, 256), (256, 64), (256, 11584),
    (256, 1024), (1024, 256),
    (256, 6288), (768, 4096), (640, 12800), (256, 16032))
# the plans measured best on the H100 (tools/gmm_plans.py sweep) for the
# decoupled FFN products, at M = 4 and at the large-batch serve's M
# (stablelm 64); qwen2's down product is the one past 16 stages of K a
# split on the wgmma route
_GMM_FFN_PLANS = {
    (1024, 256): ((1, 64), (1, 64)), (2368, 448): ((1, 64), (2, 64)),
    (864, 320): ((1, 64), (1, 64)), (256, 64): ((1, 64), (1, 64)),
    (1728, 640): ((1, 64), (1, 64)), (64, 256): ((1, 64), (1, 64)),
    (256, 1024): ((1, 64), (1, 64)), (320, 864): ((1, 64), (1, 64)),
    (640, 1728): ((1, 128), (1, 128)), (448, 2368): ((1, 192), (1, 192))}


def _waves(m, g, k, n, cols, sms=132):
    """ceil(tiles / sms) x the modelled tile time of an unsplit wgmma
    plan of ``cols`` columns, plus its last wave's stores."""
    from repro_torch.kernels import grouped_matmul as gm
    tiles = g * -(-m // 128) * -(-n // cols)
    t = -(-tiles // sms) * gm.wgmma_tile_s(m, k, cols) + \
        128 * cols * 2 / (3.35e12 / 132)
    assert t == gm.wgmma_plan_s(m, g, k, n, cols, sms)
    return t


@pytest.mark.parametrize("m", [4, 64, 128, 4096])
@pytest.mark.parametrize("k,n", [*_GMM_PLAN_SHAPES, (4096, 256),
                                 (8192, 256)])
def test_grouped_matmul_plan(k, n, m):
    """The wrapper's pure plan function on a 132-SM card. The stream
    route (M <= 8): the unsplit design (1, 192) wherever 192-column units
    fill the card, which covers every unembedding; elsewhere the
    narrowest width whose units fit one wave. The wgmma route: the width
    of the least waves x tile time (the widest on a tie), then a split in
    at most 2 that keeps 16 stages of K a split and the blocks within the
    wave; the FFN products take the plans measured best."""
    from repro_torch.kernels import grouped_matmul as gm
    g, sms = 8, 132
    r = gm.route(m, g, k, n, torch.bfloat16, 0, 0)
    assert r == ("stream" if m <= 8 else "wgmma")
    splits, cols = p = gm.plan(r, m, g, k, n, sms)
    rows = 1 if r == "stream" else -(-m // 128)

    def units(c):
        return g * rows * -(-n // c)

    stages = -(-k // gm._STAGE_K[r])
    if r == "stream":
        if units(192) >= sms:
            assert p == gm.DEFAULT_PLAN
        else:
            assert units(cols) <= sms or cols == 192
            assert all(units(c) > sms for c in gm._PLAN_COLS if c < cols)
    else:
        assert cols in gm._WGMMA_COLS
        assert all(_waves(m, g, k, n, cols) < _waves(m, g, k, n, c)
                   or (_waves(m, g, k, n, cols) == _waves(m, g, k, n, c)
                       and cols >= c) for c in gm._WGMMA_COLS)
    assert splits & (splits - 1) == 0 and 1 <= splits <= gm._MAX_SPLITS
    if splits > 1:
        assert cols in gm._SPLIT_COLS and splits * units(cols) <= sms
        assert stages >= splits * gm._SPLIT_MIN_STAGES
        assert r == "wgmma" and splits <= gm._WGMMA_MAX_SPLITS
    if (k, n) in _GMM_FFN_PLANS and m in (4, 64 if (k, n) in (
            (640, 1728), (1728, 640)) else 128):
        assert p == _GMM_FFN_PLANS[k, n][m > 8]
    if k >= 4096 and 8 < m <= 128:
        assert splits >= 2 and stages // splits >= gm._SPLIT_MIN_STAGES
    # fp32 and the routes without plans take the default
    assert gm.plan(r, m, g, k, n, sms, torch.float32) == gm.DEFAULT_PLAN
    assert gm.plan("sgemm", m, g, k, n, sms) == gm.DEFAULT_PLAN
    assert gm.plan("simt", m, g, k, n, sms) == gm.DEFAULT_PLAN


# the wgmma route's targeted rows, (M, G, K, N) and the width the wave
# rule gives them on a 132-SM card: every LM's bf16 eval chunk (M =
# 4096, chip_smoke.GMM_EVAL_CHUNKS), the bf16 lm_task eval, and the
# large-batch serve's unembeddings at M = 64-128
_GMM_TARGET_PLANS = (
    ((4096, 8, 256, 6288), 256), ((4096, 8, 256, 16032), 256),
    ((4096, 8, 448, 19008), 256), ((4096, 8, 640, 12544), 256),
    ((4096, 8, 320, 4000), 256), ((4096, 8, 768, 4096), 256),
    ((4096, 8, 640, 12800), 256), ((4096, 8, 256, 11584), 256),
    ((4096, 4, 512, 12576), 256),
    ((128, 8, 256, 6288), 192), ((128, 8, 320, 4000), 128),
    ((128, 8, 768, 4096), 128), ((64, 8, 640, 12544), 256))


@pytest.mark.parametrize("shape,cols", _GMM_TARGET_PLANS)
def test_grouped_matmul_plan_of_the_targeted_rows(shape, cols):
    """The eval chunks and unembeddings run unsplit at the width the
    wave rule gives; danube's and mixtral's unembeddings at M = 128 in
    two waves of 128 columns (one wave of 256 stores all its tiles at
    the end, under no load)."""
    from repro_torch.kernels import grouped_matmul as gm
    m, g, k, n = shape
    assert gm.route(m, g, k, n, torch.bfloat16, 0, 0) == "wgmma"
    assert gm.plan("wgmma", m, g, k, n, 132) == (1, cols)
    if m == 128 and (k, n) in ((320, 4000), (768, 4096)):
        assert -(-g * -(-n // cols) // 132) == 2
        assert -(-g * -(-n // 256) // 132) == 1


@pytest.mark.parametrize("m,g,n,route,plan", [
    (4, 65_536, 16, "stream", None), (64, 65_536, 16, "simt", None),
    (64 * 65_535 + 1, 2, 16, "simt", None),
    (128 * (2 ** 31 - 1) + 1, 1, 256, "sgemm", None),
    # other plans: G over 65,535 in 64-column units, and a split wgmma
    # plan's tiles x S over 2^31 - 1
    (4, 65_536, 16, "stream", (1, 64)),
    (128, 2, 64 * (2 ** 29 - 1) + 1, "wgmma", (2, 64))])
def test_grouped_matmul_refuses_a_grid_it_cannot_launch(monkeypatch, m, g,
                                                        n, route, plan):
    """One past a route's grid (G over 65,535 on stream and simt, simt's
    row tiles over 65,535, sgemm's 128 x 256 tiles over 2^31 - 1, a
    split wgmma plan's tiles times its splits over 2^31 - 1) the call
    raises before any launch, counted nowhere; one row, group or column
    fewer fits."""
    from repro_torch.kernels import grouped_matmul as gm
    monkeypatch.setattr(gm, "_library", lambda: None)
    before = (gm.grouped_matmul.launches,
              dict(gm.grouped_matmul.route_launches))
    p = plan or gm.DEFAULT_PLAN
    with pytest.raises(ValueError, match=rf"kernel's grid \({route} route"):
        gm.launch(FakeCuda(m, g * 4, ptr=1 << 20),
                  FakeCuda(g, 4, n, ptr=1 << 21), route, plan)
    assert (gm.grouped_matmul.launches,
            gm.grouped_matmul.route_launches) == before
    if n > 2 ** 31:
        assert gm._grid_fits(route, m, g, n - 1, p)
    else:
        assert gm._grid_fits(route, m, g - 1, n, p) if g > 2 else \
            gm._grid_fits(route, m - 1, g, n, p)


def test_grouped_matmul_refuses_autograd_on_the_card(monkeypatch):
    """On CUDA tensors the wrapper raises when autograd records the call
    (its output would carry no grad_fn and cut the gradient), before the
    build and before any launch; under no_grad it goes on to the build."""
    from repro_torch.kernels import build
    from repro_torch.kernels import grouped_matmul as gm
    monkeypatch.setattr(build, "load", _no_nvcc)
    before = gm.grouped_matmul.launches
    x = FakeCuda(4, 8 * 256, ptr=1 << 20, requires_grad=True)
    w = FakeCuda(8, 256, 6288, ptr=1 << 21)
    with pytest.raises(RuntimeError, match="no backward"):
        gm.grouped_matmul(x, w)
    with pytest.raises(RuntimeError, match="no backward"):
        gm.grouped_matmul(FakeCuda(4, 8 * 256, ptr=1 << 20),
                          FakeCuda(8, 256, 6288, ptr=1 << 21,
                                   requires_grad=True))
    with torch.no_grad(), pytest.raises(RuntimeError, match="nvcc failed"):
        gm.grouped_matmul(x, w)
    assert gm.grouped_matmul.launches == before


def test_library_path_follows_the_shared_headers(monkeypatch, tmp_path):
    """A kernel's library is keyed by its source, every ``csrc/*.cuh``
    header and the flags: editing a header it includes rebuilds it."""
    from repro_torch.kernels import build
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path("k")
    assert build.library_path("k") == first          # stable
    (tmp_path / "h.cuh").write_text("// v2\n")
    second = build.library_path("k")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new\n")
    third = build.library_path("k")
    assert third not in (first, second)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert build.library_path("k") not in (first, second, third)
