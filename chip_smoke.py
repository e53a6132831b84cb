#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each announced on its own line; any failure raises and the
script exits non-zero:

1. device   the card's name and power limit (nvidia-smi), torch/CUDA
2. build    the CUDA C++ kernels (one nvcc per source) and the Triton
            kernel, all started together
3. kernels  the kernels these paths run
4. check    each kernel against its plain PyTorch version on the card,
            at its paths' shapes (TF32 off), with device times
            (CUDA-graph replay) of the kernel, the plain version and
            one library call, beside the bound
5. main     the CLI's main path at full width (VGG9, 10 clients, 8 steps
            of batch 32): fed2 on the default routes, fed2 with
            --use-local-kernel, fedavg on the baseline VGG9; then fed2
            on --arch vgg16 (100 classes) and on --arch mobilenet
            --dirichlet 0.5; 3 rounds each. Every launch counter is set
            to 0 just before each run and read just after: every run
            fuses once per round through paired_fusion, only the
            --use-local-kernel run launches local_step (once per local
            step), and none launches feature_stats
6. auto_depth  Fed2's structure adaptation at full width
            (launch/auto_depth.py): warm-up of the baseline VGG9, Eq. 9
            through feature_stats (one launch per class per tapped
            layer), TV profile -> decouple depth, 6 rounds of Fed2 (one
            paired_fusion each); it must learn. Then Eq. 9 on the warm
            model with the kernel on and off (TF32 off)
7. profile  the main path again under torch.profiler: device busy
            share and device time by kernel category
8. parity   one fed2 round from one init and one batch stream with the
            kernels on and off (TF32 off, deterministic convolutions):
            the fusion kernel alone agrees to round-off, both kernels
            within what a one-ulp change of the init does to the round
9. scenario nxc2_fed2 for its 10 rounds, counted like the main path;
            it must learn

The last lines are the kernels' JSON record, the nvidia-smi line, and
``{"ok": true, "device": {...}}``. Nothing here imports jax or ``repro``.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS = 67e12             # H100 SXM fp32, outside the tensor cores
L2_BYTES = 50 * 2 ** 20
MAIN_ROUNDS = 3
FUSION_PARITY_TOL = 1e-5       # see phase_parity
# Eq. 9 with the feature_stats kernel vs without, on one warm model:
# tests/test_fed2_core.py's bound between the JAX package's two routes
PVEC_ATOL = PVEC_RTOL = 1e-3
# the JAX package's committed nxc2_fed2 record
# (benchmarks/artifacts_perf/scenario_nxc2_fed2.json)
SCENARIO_REFERENCE = 0.5075


@contextlib.contextmanager
def phase(name: str):
    print(f"[{name}] ...", flush=True)
    t0 = time.time()
    yield
    torch.cuda.synchronize()
    print(f"[{name}] ok ({time.time() - t0:.1f} s)", flush=True)


@contextlib.contextmanager
def tf32_off():
    """Full fp32 convolutions and matmuls (cuDNN runs fp32 convs in TF32
    by default) for the comparisons; the previous flags come back after."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


@contextlib.contextmanager
def deterministic_convs():
    """cuDNN convolutions that give the same bits on every call (its
    default algorithms may accumulate the weight gradient with atomics,
    in any order); the previous flags come back after."""
    old = (torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = old


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fns, reps: int) -> float:
    """Mean device time of one call: ``reps`` calls cycling over ``fns``
    (closures on distinct buffers, so each call finds its inputs out of
    L2 as the round does) are captured in one CUDA graph, and CUDA
    events time its replay. The graph keeps the Python wrappers' host
    time out of the number: launched eagerly one by one, these
    microsecond kernels wait on the host, not on the card."""
    for f in fns:                    # compile, allocate, pick algorithms
        f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def copies_for(nbytes: int) -> int:
    """Buffers to cycle over so that their sum exceeds L2 three times."""
    return max(2, math.ceil(3 * L2_BYTES / nbytes))


def bound(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def layout_of(cfg):
    """The flat layout of one client's parameters of model ``cfg``."""
    from repro_torch.models.cnn import init_cnn
    from repro_torch.models.module import FlatLayout
    return FlatLayout(init_cnn(torch.Generator().manual_seed(0), cfg))


def main_layout():
    """The flat layout of the main path's model, vgg9.full(fed2_groups=8)."""
    from repro_torch.configs import vgg9
    return layout_of(vgg9.full(fed2_groups=8))


def cohort(layout, n, dtype, gen, scale=1.0):
    """An (n, M) cohort buffer as the engine allocates it (row stride
    rounded up), filled with seeded normals."""
    buf = layout.alloc((n,), device="cuda", dtype=dtype)
    buf.copy_(scale * torch.randn(buf.shape, generator=gen, device="cuda"))
    return buf


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


CUDA_SOURCES = ("paired_fusion", "feature_stats")


def phase_build():
    from repro_torch.kernels import build
    from repro_torch.kernels import local_step as ls
    t0 = time.time()
    times, errors = {}, []

    def nvcc(name):
        try:
            build.load(name)
            times[f"{name} (nvcc)"] = time.time() - t0
        except BaseException as e:          # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=nvcc, args=(n,))
               for n in CUDA_SOURCES]
    for th in threads:
        th.start()
    # the Triton kernel compiles at its first launch: take the main
    # path's specialization (strided fp32 (10, M) rows)
    layout = main_layout()
    p = layout.alloc((10,), device="cuda")
    ls.local_step(p, torch.zeros_like(p), torch.zeros_like(p), lr=0.01,
                  mu=0.9)
    torch.cuda.synchronize()
    times["local_step (triton)"] = time.time() - t0
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    for k, v in times.items():
        print(f"  built {k} in {v:.1f} s")
    for name in CUDA_SOURCES:
        log = build.library_path(name).with_suffix(".log")
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas ({name}):", line.strip())


def check(name, got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    ok = err <= tol
    print(f"  {name}: max_abs_err {err:.3g} (tol {tol:g}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version ({err} > {tol})")
    return err


def phase_check_paired_fusion(layout) -> dict:
    from repro_torch.configs import vgg9
    from repro_torch.fl import scenarios
    from repro_torch.kernels.paired_fusion import (paired_fusion,
                                                   paired_fusion_ref)
    gen = torch.Generator(device="cuda").manual_seed(1)
    m = layout.size
    # the cohort buffers of the other two paths that fuse through it:
    # fedavg on vgg9.baseline() (10 clients) and nxc2_fed2 (6 clients)
    base = layout_of(vgg9.baseline())
    spec = scenarios.get("nxc2_fed2")
    scen = layout_of(spec.model_config())

    def weights(n):
        w = torch.rand(n, generator=gen, device="cuda") + 0.1
        return w / w.sum()

    # tolerances: fp32 1e-5 (tests/test_kernels.py's); bf16 1e-2, about
    # one bf16 ulp at the O(1) result, since the two fp32 sums may round
    # to neighbouring bf16 values
    cases = [("fp32 N=10 M=%d (main path)" % m,
              cohort(layout, 10, torch.float32, gen), 1e-5),
             ("bf16 N=10 M=%d" % m,
              cohort(layout, 10, torch.bfloat16, gen), 1e-2),
             ("fp32 N=1 M=%d" % m,
              cohort(layout, 1, torch.float32, gen), 1e-5),
             ("fp32 N=10 M=%d (fedavg path, vgg9.baseline)" % base.size,
              cohort(base, 10, torch.float32, gen), 1e-5),
             ("fp32 N=%d M=%d (nxc2_fed2 path)" % (spec.population,
                                                   scen.size),
              cohort(scen, spec.population, torch.float32, gen), 1e-5),
             ("fp32 N=10 odd M=100003, row stride 100003",
              torch.randn(10, 100003, generator=gen, device="cuda"), 1e-5),
             ("fp32 N=10 M=1001 at column 3 (unaligned group block)",
              cohort(layout, 10, torch.float32, gen)[:, 3:1004], 1e-5)]
    err_main = None
    for name, x, tol in cases:
        w = weights(x.shape[0])
        err = check(f"paired_fusion {name}", paired_fusion(x, w),
                    paired_fusion_ref(x, w), tol)
        err_main = err if err_main is None else err_main
    # timing at the main path's shape
    n, esz = 10, 4
    xs = [cohort(layout, n, torch.float32, gen)
          for _ in range(copies_for(n * m * esz))]
    w = weights(n)
    reps = 200
    ms = time_ms([lambda x=x: paired_fusion(x, w) for x in xs], reps)
    plain = time_ms([lambda x=x: paired_fusion_ref(x, w) for x in xs], reps)
    lib = time_ms([lambda x=x: torch.mv(x.t(), w) for x in xs], reps)
    b, by = bound(n * m * esz + m * esz + n * 4, 2 * n * m)
    return {"name": "paired_fusion", "route": "cuda",
            "source": "src/repro_torch/csrc/paired_fusion.cu",
            "replaces": "src/repro/kernels/paired_fusion.py:43",
            "max_abs_err": err_main, "ms": ms, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": lib}


def phase_check_local_step(layout) -> dict:
    from repro_torch.kernels.local_step import local_step, local_step_ref
    gen = torch.Generator(device="cuda").manual_seed(2)
    lr, mu = 0.01, 0.9
    m = layout.size
    # tolerances: fp32 1e-6 and bf16 2e-2, tests/test_kernels.py's
    cases = [("fp32 (10, %d) cohort rows (main path)" % m, torch.float32,
              lambda: cohort(layout, 10, torch.float32, gen), 1e-6),
             ("bf16 (10, %d) cohort rows" % m, torch.bfloat16,
              lambda: cohort(layout, 10, torch.bfloat16, gen), 2e-2),
             ("fp32 odd M=100003", torch.float32,
              lambda: torch.randn(100003, generator=gen, device="cuda"),
              1e-6)]
    err_main = None
    for name, dt, make, tol in cases:
        p, v, g = make(), 0.1 * make(), make()
        wp, wv = local_step_ref(p, v, g, lr, mu)
        local_step(p, v, g, lr=lr, mu=mu)           # in place
        err = max(check(f"local_step {name} p", p, wp, tol),
                  check(f"local_step {name} v", v, wv, tol))
        err_main = err if err_main is None else err_main
    r, esz = 10, 4
    sets = [tuple(cohort(layout, r, torch.float32, gen, s)
                  for s in (1.0, 0.1, 1.0))
            for _ in range(copies_for(3 * r * m * esz))]
    reps = 100
    ms = time_ms([lambda s=s: local_step(*s, lr=lr, mu=mu) for s in sets],
                 reps)
    plain = time_ms([lambda s=s: local_step_ref(*s, lr, mu) for s in sets],
                    reps)
    # library yardstick: the fused SGD op behind torch.optim.SGD(
    # fused=True), on contiguous copies (it takes dense tensors only)
    dense = [tuple(t.contiguous() for t in s) for s in sets]
    lib = time_ms([lambda s=s: torch._fused_sgd_(
        [s[0]], [s[2]], [s[1]], weight_decay=0.0, momentum=mu, lr=lr,
        dampening=0.0, nesterov=False, maximize=False, is_first_step=False)
        for s in dense], reps)
    b, by = bound(5 * r * m * esz, 4 * r * m)
    return {"name": "local_step", "route": "triton",
            "source": "src/repro_torch/kernels/local_step.py",
            "replaces": "src/repro/kernels/local_step.py:47",
            "max_abs_err": err_main, "ms": ms, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": lib}


def auto_depth_widths():
    """The neuron counts of the layers Eq. 9 taps on the auto-depth
    path's warm-up model (every conv and hidden FC)."""
    from repro_torch.launch import auto_depth
    from repro_torch.models.cnn import layer_meta
    warm_cfg, _ = auto_depth.model_configs(reduced=False)
    return [m.c_out for m in layer_meta(warm_cfg)
            if m.kind in ("c", "dw", "fc")]


def phase_check_feature_stats() -> dict:
    from repro_torch.kernels.feature_stats import (feature_stats,
                                                   feature_stats_ref)
    from repro_torch.launch import auto_depth
    gen = torch.Generator(device="cuda").manual_seed(3)

    def pair(b, i, dt):
        return tuple(torch.randn(b, i, generator=gen, device="cuda").to(dt)
                     for _ in range(2))

    def check_fs(name, b, i, dt):
        a, g = pair(b, i, dt)
        got, want = feature_stats(a, g), feature_stats_ref(a, g)
        err = (got - want).abs()
        if dt == torch.float32:
            # 1e-5 of the column's sum of |a*g|: fp32 sums of B terms
            # taken in another order
            scale = (a.float() * g.float()).abs().sum(0)
            ok = bool((err <= 1e-5 * scale).all())
            lim = "1e-5 x sum|a*g| per column"
        else:   # the JAX test's bf16 bounds (tests/test_kernels.py)
            ok = bool((err <= 0.2 + 1e-2 * want.abs()).all())
            lim = "atol 0.2 + rtol 1e-2"
        e = err.max().item()
        print(f"  feature_stats {name} ({b}, {i}) {str(dt)[6:]}: "
              f"max_abs_err {e:.3g} ({lim}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"feature_stats {name} ({b}, {i}) {dt}: "
                                 "kernel disagrees with its plain version")
        return e

    for b, i in ((32, 100), (256, 512), (100, 1000), (7, 3)):
        for dt in (torch.float32, torch.bfloat16):
            check_fs("JAX test shape", b, i, dt)
    path_b = auto_depth.PROBE_IMAGES
    err_path = max(check_fs("auto-depth path", path_b, i, torch.float32)
                   for i in sorted(set(auto_depth_widths())))
    check_fs("large", 8192, 4096, torch.float32)
    check_fs("large", 8192, 4096, torch.bfloat16)

    timings = {}
    for b, i in ((path_b, max(auto_depth_widths())), (8192, 4096)):
        nbytes = 2 * b * i * 4
        pairs = [pair(b, i, torch.float32)
                 for _ in range(copies_for(nbytes))]
        reps = max(20 if b * i > 1e6 else 200, len(pairs))
        t = {"ms": time_ms([lambda p=p: feature_stats(*p) for p in pairs],
                           reps),
             "plain_ms": time_ms([lambda p=p: feature_stats_ref(*p)
                                  for p in pairs], reps),
             "library_ms": time_ms([lambda p=p: torch.linalg.vecdot(
                 p[0], p[1], dim=0) for p in pairs], reps)}
        t["bound_ms"], t["bound_by"] = bound(nbytes + 4 * i, 2 * b * i)
        timings[(b, i)] = t
        print(f"  feature_stats ({b}, {i}) fp32: {t['ms'] * 1e3:.2f} us, "
              f"plain {t['plain_ms'] * 1e3:.2f} us, torch.linalg.vecdot "
              f"{t['library_ms'] * 1e3:.2f} us, bound "
              f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']})")
    path = timings[(path_b, max(auto_depth_widths()))]
    return {"name": "feature_stats", "route": "cuda",
            "source": "src/repro_torch/csrc/feature_stats.cu",
            "replaces": "src/repro/kernels/feature_stats.py:43",
            "max_abs_err": err_path, **path}


def finite_params(h):
    from repro_torch.models.module import tree_leaves
    leaves = tree_leaves(h["final_params"])
    assert leaves and all(bool(torch.isfinite(t).all()) for t in leaves), \
        "non-finite final parameters"
    assert all(t.is_cuda for t in leaves), "final parameters left the card"


def cli(*extra):
    from repro_torch.launch import train
    argv = ["--mode", "fl", "--rounds", str(MAIN_ROUNDS), *extra]
    print("  python -m repro_torch.launch.train", " ".join(argv), flush=True)
    h = train.main(argv)
    finite_params(h)
    w = h["wall"]
    print(f"  -> {MAIN_ROUNDS / h['wall_total']:.3f} rounds/s over the run "
          f"({h['wall_total']:.3f} s; first round {w[0]:.3f} s, later "
          f"rounds {(w[-1] - w[0]) / (len(w) - 1):.3f} s each), final acc "
          f"{h['acc'][-1]:.4f}", flush=True)
    return h


def counted(label: str, run, expect: dict):
    """``run()`` with every launch counter set to 0 just before it and
    read just after; the counts must equal ``expect``."""
    from repro_torch.kernels.feature_stats import feature_stats
    from repro_torch.kernels.local_step import local_step
    from repro_torch.kernels.paired_fusion import paired_fusion
    paired_fusion.launches = local_step.launches = 0
    feature_stats.launches = 0
    out = run()
    counts = {"paired_fusion": paired_fusion.launches,
              "local_step": local_step.launches,
              "feature_stats": feature_stats.launches}
    print(f"  launches, {label}: {counts} (expected {expect})", flush=True)
    assert counts == expect, f"{label}: launches {counts} != {expect}"
    return out, counts


def phase_main() -> dict:
    """Returns the launch counts of the run that takes both kernels."""
    from repro_torch.launch import train
    d = train.parse_args([])                    # the CLI's defaults
    steps = d.local_epochs * d.steps_per_epoch
    fuse_only = {"paired_fusion": MAIN_ROUNDS, "local_step": 0,
                 "feature_stats": 0}
    counted("fed2, default routes",
            lambda: cli("--method", "fed2"), fuse_only)
    _, counts = counted(
        "fed2 --use-local-kernel",
        lambda: cli("--method", "fed2", "--use-local-kernel"),
        {"paired_fusion": MAIN_ROUNDS, "local_step": steps * MAIN_ROUNDS,
         "feature_stats": 0})
    counted("fedavg", lambda: cli("--method", "fedavg"), fuse_only)
    # the paper's other testbeds: vgg16.full(fed2_groups=8) on 100
    # classes (104 logits), MobileNetV1 on a Dir(0.5) split
    counted("fed2 --arch vgg16",
            lambda: cli("--method", "fed2", "--arch", "vgg16"), fuse_only)
    counted("fed2 --arch mobilenet --dirichlet 0.5",
            lambda: cli("--method", "fed2", "--arch", "mobilenet",
                        "--dirichlet", "0.5"), fuse_only)
    return counts


def phase_auto_depth() -> int:
    """The full-width structure-adaptation path; returns its
    feature_stats launches."""
    from repro_torch.core.feature_stats import class_preference_vectors
    from repro_torch.launch import auto_depth
    n_cls, taps = 10, len(auto_depth_widths())
    out, counts = counted(
        "auto_depth (full width)",
        lambda: auto_depth.run_auto_depth(device="cuda", log=print),
        {"paired_fusion": auto_depth.ROUNDS, "local_step": 0,
         "feature_stats": n_cls * taps})
    h = out["history"]
    finite_params(h)
    w = h["wall"]
    print(f"  TV profile {[round(t, 4) for t in out['tvs']]} -> decouple "
          f"{out['depth']} ({out['cfg'].n_weight_layers} weight layers); "
          f"fed2 {auto_depth.ROUNDS} rounds in {h['wall_total']:.3f} s "
          f"(later rounds {(w[-1] - w[0]) / (len(w) - 1):.3f} s each); "
          f"accs {[round(a, 4) for a in h['acc']]}")
    assert h["acc"][-1] > 0.1 and h["acc"][-1] > h["acc"][0], \
        "auto-depth fed2 did not learn (final <= chance or first round)"
    with tf32_off(), deterministic_convs():
        on = class_preference_vectors(out["warm_params"], out["warm_cfg"],
                                      *out["probe"], use_kernel=True)
        off = class_preference_vectors(out["warm_params"], out["warm_cfg"],
                                       *out["probe"], use_kernel=False)
    err = max((a - b).abs().max().item() for a, b in zip(on, off))
    ok = all(torch.allclose(a, b, atol=PVEC_ATOL, rtol=PVEC_RTOL)
             for a, b in zip(on, off))
    print(f"  Eq. 9 on the warm model, feature_stats kernel vs plain "
          f"(TF32 off): max_abs_err {err:.3g} (atol {PVEC_ATOL:g}, rtol "
          f"{PVEC_RTOL:g}) {'ok' if ok else 'FAIL'}")
    assert ok, "Eq. 9 through the kernel disagrees with the plain route"
    return counts["feature_stats"]


def _category(name: str) -> str:
    n = name.lower()
    for cat, keys in (("paired_fusion", ("paired_fusion",)),
                      ("local_step", ("local_step",)),
                      ("memcpy/memset", ("memcpy", "memset")),
                      ("conv (cuDNN)", ("conv", "cudnn", "xmma", "implicit",
                                        "wgrad", "dgrad", "winograd")),
                      ("gemm", ("gemm", "gemv", "cutlass", "cublas"))):
        if any(k in n for k in keys):
            return cat
    return "other (elementwise, reductions, norms, pooling)"


def phase_profile():
    """The main path (fed2, --use-local-kernel, 3 rounds) under
    torch.profiler: device time by kernel category, and the share of
    the run's wall time in which the card ran a kernel or a copy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fl.runtime import run_federated
    from repro_torch.launch import train
    inputs = train.fl_inputs(train.parse_args(["--rounds", "3"]))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run_federated(*inputs, use_local_kernel=True, device="cuda")
        wall = time.time() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    total_us = sum(e.self_device_time_total for e in dev)
    print(f"  3 rounds: wall {wall * 1e3:.1f} ms, device busy "
          f"{total_us / 1e3:.1f} ms ({100 * total_us / 1e3 / wall / 1e3:.1f}"
          f" %), {sum(e.count for e in dev)} device ops")
    if not dev:
        print("  device time: not measured (the profiler saw no device "
              "events)")
        return
    by_cat = {}
    for e in dev:
        c = _category(e.key)
        by_cat[c] = by_cat.get(c, 0.0) + e.self_device_time_total
    for c, us in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {c:<48s} {us / 1e3:8.2f} ms  {100 * us / total_us:5.1f} %")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"    {e.self_device_time_total / 1e3:8.2f} ms x{e.count:<5d} "
              f"{e.key[:90]}")


def phase_parity():
    """One fed2 round from one init and one batch stream, with TF32 off
    and deterministic convolutions, so that runs of one route agree bit
    for bit and routes differ only by the kernels:

    - fusion kernel only vs plain: the local phases are identical, so
      the fused globals differ by the fusion's fp32 summation order
      alone; tolerance 1e-5, the kernel check's;
    - both kernels vs plain: ``local_step`` rounds the momentum step
      differently (fused multiply-adds), and 8 local steps carry that
      through the net. The limit is what the same round makes of a
      one-ulp change of the initial parameters on the plain route: the
      kernels may move the result no further than round-off in the
      inputs does."""
    from repro_torch.fl.runtime import run_federated
    from repro_torch.launch import train
    from repro_torch.models.module import tree_leaves, tree_map
    task, fl, parts, get_batch, test = train.fl_inputs(
        train.parse_args(["--rounds", "1"]))
    init = task.init_fn(torch.Generator().manual_seed(0))
    ulp = tree_map(lambda t: torch.nextafter(t, torch.full_like(
        t, math.inf)), init)
    out = {}
    for label, fuse_k, local_k, start in (
            ("plain", False, False, init), ("plain again", False, False, init),
            ("fusion kernel", True, False, init),
            ("both kernels", True, True, init),
            ("plain, init + 1 ulp", False, False, ulp)):
        out[label] = run_federated(task, fl, parts, get_batch, test,
                                   use_kernel=fuse_k,
                                   use_local_kernel=local_k, device="cuda",
                                   init_params=start)
        finite_params(out[label])

    def max_diff(a):
        return max((x - y).abs().max().item()
                   for x, y in zip(tree_leaves(out[a]["final_params"]),
                                   tree_leaves(out["plain"]["final_params"])))

    d = {k: max_diff(k) for k in out if k != "plain"}
    for k, v in d.items():
        print(f"  max |dparam| after one round, {k} vs plain: {v:.3g}")
    print(f"  acc: both kernels {out['both kernels']['acc'][-1]:.4f}, "
          f"plain {out['plain']['acc'][-1]:.4f}")
    assert d["fusion kernel"] <= FUSION_PARITY_TOL, \
        f"fusion kernel route drifts from plain: {d['fusion kernel']}"
    assert d["both kernels"] <= d["plain, init + 1 ulp"], (
        f"kernel routes drift from plain ({d['both kernels']}) beyond a "
        f"one-ulp change of the init ({d['plain, init + 1 ulp']})")


def phase_scenario():
    from repro_torch.fl import scenarios
    spec = scenarios.get("nxc2_fed2")
    rec, _ = counted(
        "nxc2_fed2", lambda: scenarios.run_scenario(spec, device="cuda"),
        {"paired_fusion": spec.rounds, "local_step": 0,
         "feature_stats": 0})
    print(f"  nxc2_fed2 ({spec.rounds} rounds, {rec.wall_total:.2f} s): "
          f"final acc {rec.final_acc:.4f} (the JAX package's committed "
          f"record: {SCENARIO_REFERENCE}; inits differ), accs "
          f"{[round(a, 4) for a in rec.acc]}")
    assert rec.final_acc > 0.2, "nxc2_fed2 did not learn (<= 2x chance)"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)

    with phase("device"):
        smi = nvidia_smi()
        print(f"  {smi}")
        import triton
        print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"triton {triton.__version__}, "
              f"{torch.cuda.get_device_name(0)} x "
              f"{torch.cuda.device_count()}")
    with phase("build"):
        phase_build()
    print("[kernels] paired_fusion (cuda: src/repro_torch/csrc/"
          "paired_fusion.cu), local_step (triton: src/repro_torch/kernels/"
          "local_step.py), feature_stats (cuda: src/repro_torch/csrc/"
          "feature_stats.cu)", flush=True)
    layout = main_layout()
    with phase("check (TF32 off)"), tf32_off():
        records = [phase_check_paired_fusion(layout),
                   phase_check_local_step(layout),
                   phase_check_feature_stats()]
        for r in records:
            print(f"  {r['name']}: {r['ms'] * 1e3:.1f} us, plain "
                  f"{r['plain_ms'] * 1e3:.1f} us, library "
                  f"{r['library_ms'] * 1e3:.1f} us, bound "
                  f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']})")
    with phase("main"):
        counts = phase_main()
    with phase("auto_depth"):
        counts["feature_stats"] = phase_auto_depth()
    with phase("profile"):
        phase_profile()
    with phase("parity (TF32 off, deterministic convs)"), tf32_off(), \
            deterministic_convs():
        phase_parity()
    with phase("scenario"):
        phase_scenario()
    for r in records:
        r["launches"] = counts[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in records]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
