#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each announced on its own line; any failure raises and the
script exits non-zero:

1. device   the card's name and power limit (nvidia-smi), torch/CUDA
2. build    the CUDA C++ kernels (one nvcc per source) and the Triton
            kernel, all started together; each CUDA kernel's registers
            and spills (ptxas) and grouped_matmul's dynamic shared memory
3. kernels  the kernels these paths run
4. check    each kernel against its plain PyTorch version on the card,
            at its paths' shapes and on ragged ones (TF32 off), with
            device times (CUDA-graph replay) of the kernel, the plain
            version and one library call (where one exists), beside the
            bound; feature_stats also as feature_stats_many on segment
            tables (auto-depth's, ragged and misaligned ones, one over a
            launch's capacity, vgg16's 100 x 15), and Eq. 9's reduction
            timed as one batched launch, as 80 single-pair calls and as
            8 torch.linalg.vecdot calls
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
            through feature_stats (one feature_stats_many launch for
            all 10 classes x 8 tapped layers), TV profile -> decouple
            depth, 6 rounds of Fed2 (one paired_fusion each); it must
            learn. Then Eq. 9 on the warm model with the kernel on and
            off (TF32 off): preference vectors, TV profile and depth
            agree; and each route's wall time, median of 5
7. profile  the main path again under torch.profiler: device busy
            share and device time by kernel category
8. parity   one fed2 round from one init and one batch stream with the
            kernels on and off (TF32 off, deterministic convolutions):
            the fusion kernel alone agrees to round-off, both kernels
            within what a one-ulp change of the init does to the round
9. scenario nxc2_fed2 for its 10 rounds, counted like the main path;
            it must learn
10. serve   Mamba-2 1.3B at full width through the serving CLI
            (launch/serve.py, the reference's defaults: batch 4, 32
            prompt + 16 decoded tokens): --full (ssd_update in every
            layer of every step: 48 x 48 launches) and --full
            --fed2-groups 8 (also grouped_matmul, once a step, on its
            stream route), then --batch 128 with Fed2 (decode_32k's
            batch: a 12.9 GB SSM state; grouped_matmul's wgmma route);
            counted, grouped_matmul by route too, with prefill/decode
            time, tok/s, peak device memory and the parameter count,
            which must equal the reference's
11. serve profile  a short Fed2 serve under torch.profiler: device
            busy share and device time by kernel category
12. decode parity  the full config in fp32 (TF32 off), 8 tokens, with
            the kernels and with the plain versions: logits and the
            final cache within the stated limits

The last lines are the kernels' JSON record, the nvidia-smi line, and
``{"ok": true, "device": {...}}``. Nothing here imports jax or ``repro``.
"""
from __future__ import annotations

import contextlib
import gc
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
BF16_FLOPS = 989e12            # H100 SXM bf16, dense tensor cores
# parameters of mamba2-1.3b and of with_fed2(groups=8) of it: the
# reference's param_count(jax.eval_shape(init_params, ...)) on its
# configs/mamba2_1_3b.full()
SERVE_PARAMS = {0: 1_446_812_672, 8: 1_356_667_904}
SERVE_LAYERS = 48
# decode parity, kernels vs plain versions at full width in fp32: fp32
# round-off (~1e-7 relative per operation) carried through 48 layers
# and 8 tokens stays orders of magnitude below these; a wrong index or a
# lost term moves logits (O(1)) and the state by O(1)
PARITY_LOGIT_ATOL = 1e-3
PARITY_STATE_RTOL = 1e-4   # of the cache leaf's max |value|


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


def bound(nbytes: float, flops: float, peak: float = FP32_FLOPS) -> tuple:
    """The least time (ms) for ``nbytes`` of device memory traffic and
    ``flops`` operations at ``peak`` (the rate of their type), and which
    of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
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


CUDA_SOURCES = ("paired_fusion", "feature_stats", "grouped_matmul",
                "ssd_update")


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
        entry = "?"
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                print(f"  ptxas ({name}, {demangled(entry)}):", line.strip())
    from repro_torch.kernels import grouped_matmul as gm
    for r, dt in (("stream", torch.bfloat16), ("stream", torch.float32),
                  ("wgmma", torch.bfloat16)):
        print(f"  grouped_matmul {r} route, {str(dt)[6:]}: "
              f"{gm.dynamic_smem(r, dt)} bytes of dynamic shared memory "
              f"per block")


def demangled(symbol: str) -> str:
    """A kernel's name and template arguments, as c++filt gives them (the
    symbol itself where c++filt is missing)."""
    try:
        out = subprocess.run(["c++filt", symbol], capture_output=True,
                             text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return symbol
    name = (out or symbol).replace("(anonymous namespace)::", "")
    return name.removeprefix("void ").split("(")[0]


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


def tapped_widths(cfg):
    """The neuron counts of the layers Eq. 9 taps on model ``cfg`` (every
    conv and hidden FC)."""
    from repro_torch.models.cnn import layer_meta
    return [m.c_out for m in layer_meta(cfg) if m.kind in ("c", "dw", "fc")]


def auto_depth_widths():
    """The tapped widths of the auto-depth path's warm-up model."""
    from repro_torch.launch import auto_depth
    return tapped_widths(auto_depth.model_configs(reduced=False)[0])


def fs_within(got, want, a, g, dt) -> tuple:
    """feature_stats' agreement rule: fp32 within 1e-5 of the column's
    sum of |a*g| (fp32 sums of B terms taken in another order), bf16 at
    the JAX test's bounds (tests/test_kernels.py). ``a``, ``g`` reduce
    over dim -2 into ``got``'s columns. Returns (max error, ok, rule)."""
    err = (got - want).abs()
    if dt == torch.float32:
        scale = (a.float() * g.float()).abs().sum(-2)
        return (err.max().item(), bool((err <= 1e-5 * scale).all()),
                "1e-5 x sum|a*g| per column")
    return (err.max().item(), bool((err <= 0.2 + 1e-2 * want.abs()).all()),
            "atol 0.2 + rtol 1e-2")


def fs_table(shapes, dt, gen, misalign=False):
    """One feature_stats_many table on the card: (a, g, outs) lists for
    (S, B, I) segments; ``misalign`` starts every a and g one element
    past a 16-byte boundary. The outs alternate between contiguous (I, S)
    tensors, as Eq. 9's (I_l, C) preference tensors are, and (I, S) views
    of (S, I) rows."""
    a_list, g_list, outs = [], [], []
    for k, (s, b, i) in enumerate(shapes):
        for lst in (a_list, g_list):
            n = s * b * i
            flat = torch.randn(n + 1, generator=gen, device="cuda").to(dt)
            lst.append(flat[1:] if misalign else flat[:n])
            lst[-1] = lst[-1].view(s, b, i)
        outs.append(torch.empty((i, s), device="cuda") if k % 2 == 0
                    else torch.empty((s, i), device="cuda").t())
    return a_list, g_list, outs


def fs_table_bytes(shapes, esize=4) -> tuple:
    """(bytes, flops) of a table: each input read once, each output
    written once."""
    nbytes = sum(2 * s * b * i * esize + 4 * s * i for s, b, i in shapes)
    return nbytes, sum(2 * s * b * i for s, b, i in shapes)


def phase_check_feature_stats() -> dict:
    from repro_torch.configs import vgg16
    from repro_torch.kernels.feature_stats import (
        feature_stats, feature_stats_many, feature_stats_many_ref,
        feature_stats_ref, feature_stats_table_capacity)
    from repro_torch.launch import auto_depth
    gen = torch.Generator(device="cuda").manual_seed(3)

    def pair(b, i, dt):
        return tuple(torch.randn(b, i, generator=gen, device="cuda").to(dt)
                     for _ in range(2))

    def check_fs(name, b, i, dt):
        a, g = pair(b, i, dt)
        got, want = feature_stats(a, g), feature_stats_ref(a, g)
        e, ok, lim = fs_within(got, want, a, g, dt)
        print(f"  feature_stats {name} ({b}, {i}) {str(dt)[6:]}: "
              f"max_abs_err {e:.3g} ({lim}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"feature_stats {name} ({b}, {i}) {dt}: "
                                 "kernel disagrees with its plain version")
        return e

    cap = feature_stats_table_capacity()

    def check_many(name, shapes, dt, misalign=False):
        a_l, g_l, outs = fs_table(shapes, dt, gen, misalign)
        before = feature_stats.launches
        got = feature_stats_many(a_l, g_l, outs)
        launches = feature_stats.launches - before
        want = feature_stats_many_ref(a_l, g_l)
        errs = [fs_within(p.t(), w.t(), a, g, dt)
                for p, w, a, g in zip(got, want, a_l, g_l)]
        e, ok = max(x[0] for x in errs), all(x[1] for x in errs)
        expect = -(-len(shapes) // cap)
        print(f"  feature_stats_many {name}: {len(shapes)} segments, "
              f"{sum(s for s, _, _ in shapes)} instances, "
              f"{str(dt)[6:]}{', misaligned' if misalign else ''}: "
              f"max_abs_err {e:.3g} ({errs[0][2]}), {launches} launches "
              f"(expected {expect}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"feature_stats_many {name} {dt}: kernel "
                                 "disagrees with its plain version")
        assert launches == expect, f"feature_stats_many {name}: launches"
        return e

    for b, i in ((32, 100), (256, 512), (100, 1000), (7, 3)):
        for dt in (torch.float32, torch.bfloat16):
            check_fs("JAX test shape", b, i, dt)
    path_b = auto_depth.PROBE_IMAGES
    n_cls = 10
    for i in sorted(set(auto_depth_widths())):
        check_fs("auto-depth pair", path_b, i, torch.float32)
    check_fs("large", 8192, 4096, torch.float32)
    check_fs("large", 8192, 4096, torch.bfloat16)
    check_fs("large, rows not a multiple of the split", 8191, 4095,
             torch.float32)

    # the batched call: Eq. 9's table on the auto-depth path (one segment
    # of n_cls instances per tapped layer), ragged and misaligned tables,
    # more segments than one launch takes, and vgg16's 100 x 15 table
    table = [(n_cls, path_b, i) for i in auto_depth_widths()]
    err_path = check_many("auto-depth table", table, torch.float32)
    check_many("auto-depth table", table, torch.bfloat16)
    ragged = [(3, 7, 3), (1, 100, 1000), (5, 64, 70), (2, 1, 33),
              (4, 33, 130), (1, 1, 1), (2, 300, 129), (6, 64, 520)]
    for dt in (torch.float32, torch.bfloat16):
        check_many("ragged", ragged, dt)
        check_many("ragged", ragged, dt, misalign=True)
    check_many("over capacity", [(2, 16 + k, 8 + 4 * k)
                                 for k in range(cap + 8)], torch.float32)
    check_many("vgg16 table", [(100, path_b, i) for i in
                               tapped_widths(vgg16.baseline())],
               torch.float32)

    # Eq. 9's reduction on the auto-depth path, four ways: one batched
    # launch, the single-pair kernel once per (class, layer), the nearest
    # library route (one vecdot per layer) and the plain version
    nbytes, flops = fs_table_bytes(table)
    tables = [fs_table(table, torch.float32, gen)
              for _ in range(copies_for(nbytes))]
    reps = max(20, len(tables))
    t = {"ms": time_ms([lambda t=t: feature_stats_many(*t)
                        for t in tables], max(200, reps)),
         "old_ms": time_ms([lambda t=t: [feature_stats(a[c], g[c])
                                         for a, g in zip(t[0], t[1])
                                         for c in range(n_cls)]
                            for t in tables], reps),
         "library_ms": time_ms([lambda t=t: [torch.linalg.vecdot(a, g, dim=1)
                                             for a, g in zip(t[0], t[1])]
                                for t in tables], reps),
         "plain_ms": time_ms([lambda t=t: feature_stats_many_ref(t[0], t[1])
                              for t in tables], reps)}
    t["bound_ms"], t["bound_by"] = bound(nbytes, flops)
    # the floor under any launch: a table of one (1, 1, 1) segment
    tiny = [fs_table([(1, 1, 1)], torch.float32, gen) for _ in range(4)]
    floor_ms = time_ms([lambda t=t: feature_stats_many(*t) for t in tiny],
                       200)
    print(f"  Eq. 9 reduction, auto-depth table ({len(table)} segments of "
          f"{n_cls} x ({path_b}, I), {nbytes / 1e6:.3f} MB) fp32: one "
          f"feature_stats_many launch {t['ms'] * 1e3:.2f} us; "
          f"{n_cls * len(table)} feature_stats calls "
          f"{t['old_ms'] * 1e3:.2f} us; {len(table)} torch.linalg.vecdot "
          f"calls {t['library_ms'] * 1e3:.2f} us; plain "
          f"{t['plain_ms'] * 1e3:.2f} us; bound {t['bound_ms'] * 1e3:.3f} "
          f"us ({t['bound_by']}); {t['bound_ms'] / t['ms'] * 100:.1f} % of "
          f"the bound; one launch of a (1, 1, 1) table "
          f"{floor_ms * 1e3:.2f} us")

    for b, i in ((path_b, max(auto_depth_widths())), (8192, 4096)):
        nb = 2 * b * i * 4
        pairs = [pair(b, i, torch.float32) for _ in range(copies_for(nb))]
        r = max(20 if b * i > 1e6 else 200, len(pairs))
        tp = {"ms": time_ms([lambda p=p: feature_stats(*p) for p in pairs],
                            r),
              "plain_ms": time_ms([lambda p=p: feature_stats_ref(*p)
                                   for p in pairs], r),
              "library_ms": time_ms([lambda p=p: torch.linalg.vecdot(
                  p[0], p[1], dim=0) for p in pairs], r)}
        tp["bound_ms"], tp["bound_by"] = bound(nb + 4 * i, 2 * b * i)
        print(f"  feature_stats ({b}, {i}) fp32: {tp['ms'] * 1e3:.2f} us, "
              f"plain {tp['plain_ms'] * 1e3:.2f} us, torch.linalg.vecdot "
              f"{tp['library_ms'] * 1e3:.2f} us, bound "
              f"{tp['bound_ms'] * 1e3:.2f} us ({tp['bound_by']})")
    return {"name": "feature_stats", "route": "cuda",
            "source": "src/repro_torch/csrc/feature_stats.cu",
            "replaces": "src/repro/kernels/feature_stats.py:43",
            "max_abs_err": err_path, **t}


def ssd_inputs(b, h, p, n, dt_x, gen, state=None):
    """Inputs of one ssd_update call as the decode makes them: x, b and c
    views into one (B, H*P + 2N) row of dtype ``dt_x``, dt > 0 after a
    softplus, a_log as the model inits it."""
    row = torch.randn(b, h * p + 2 * n, generator=gen, device="cuda")
    row = row.to(dt_x)
    x = row[:, :h * p].reshape(b, h, p)
    bm, cm = row[:, h * p:h * p + n], row[:, h * p + n:]
    if state is None:
        state = torch.randn(b, h, p, n, generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(
        torch.randn(b, h, generator=gen, device="cuda"))
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device="cuda"))
    d = 1.0 + 0.1 * torch.randn(h, generator=gen, device="cuda")
    return state, x, dt, a_log, bm, cm, d


def phase_check_ssd_update() -> dict:
    """ssd_update against ssd_update_ref at the serve path's shapes
    (batch 4 and decode_32k's 128, H = P = 64, N = 128; x in bf16 as at
    full width, and fp32) and on ragged shapes; in place (out = h) as
    the decode calls it, and into a fresh buffer.

    Limits: h' within 1e-5 (fp32; both compute decay*h + dt*x*b with
    one rounding more or less); y within 1e-5 of sum_n |h'_n c_n| +
    |d x| per output (fp32 sums of N terms in another order), plus one
    bf16 step of |y| when y is bf16."""
    from repro_torch.kernels.ssd_update import ssd_update, ssd_update_ref
    gen = torch.Generator(device="cuda").manual_seed(4)
    bf16, f32 = torch.bfloat16, torch.float32

    def check_one(name, b, h, p, n, dt_x, in_place=True, misalign=False):
        args = ssd_inputs(b, h, p, n, dt_x, gen)
        if misalign:     # a state that is not 16-byte aligned: scalar path
            buf = torch.empty(args[0].numel() + 1, device="cuda")
            st = buf[1:].view(args[0].shape)
            st.copy_(args[0])
            args = (st,) + args[1:]
        want_h, want_y = ssd_update_ref(*args)
        scale = torch.einsum("bhpn,bn->bhp", want_h.abs(),
                             args[5].float().abs()) + \
            (args[6][None, :, None] * args[1].float()).abs()
        # in place on a copy (the unaligned state is its own copy)
        state = args[0].clone() if in_place and not misalign else args[0]
        got_h, got_y = ssd_update(state, *args[1:],
                                  out=state if in_place else None)
        assert (got_h is state) == in_place
        eh = (got_h - want_h).abs().max().item()
        dy = (got_y.float() - want_y.float()).abs()
        lim = 1e-5 * scale
        if dt_x == bf16:
            lim = lim + 2.0 ** -7 * want_y.float().abs()
        ey = dy.max().item()
        ok = eh <= 1e-5 and bool((dy <= lim).all())
        print(f"  ssd_update {name} ({b}, {h}, {p}, {n}) x "
              f"{str(dt_x)[6:]}{' in place' if in_place else ''}: "
              f"max_abs_err h' {eh:.3g} (tol 1e-5), y {ey:.3g} (tol "
              f"{'1e-5 x sum|h c| + |d x|' + (' + 2^-7|y|' if dt_x == bf16 else '')}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"ssd_update {name}: kernel disagrees with "
                                 "its plain version")
        return max(eh, ey)

    err_path = max(check_one("serve path", 4, 64, 64, 128, bf16),
                   check_one("serve path", 4, 64, 64, 128, f32))
    check_one("decode_32k batch", 128, 64, 64, 128, bf16)
    check_one("decode_32k batch", 128, 64, 64, 128, f32, in_place=False)
    for shape in ((3, 5, 7, 9), (2, 6, 33, 130), (2, 3, 40, 36),
                  (1, 1, 1, 1), (2, 9, 100, 260)):
        check_one("ragged", *shape, f32)
        check_one("ragged", *shape, bf16, in_place=False)
    check_one("unaligned state", 2, 4, 16, 128, f32, misalign=True)

    timings = {}
    for b in (4, 128):
        h, p, n = 64, 64, 128
        # the state read and written (fp32); x, b, c read and y written
        # (bf16); dt, a_log, d_skip read (fp32)
        nbytes = 8 * b * h * p * n + 2 * (2 * b * h * p + 2 * b * n) \
            + 4 * (b * h + 2 * h)
        sets = [ssd_inputs(b, h, p, n, bf16, gen)
                for _ in range(copies_for(nbytes))]
        reps = max(200 if b == 4 else 40, len(sets))
        t = {"ms": time_ms([lambda a=a: ssd_update(*a, out=a[0])
                            for a in sets], reps),
             "plain_ms": time_ms([lambda a=a: ssd_update_ref(*a)
                                  for a in sets], reps),
             "library_ms": None}
        t["bound_ms"], t["bound_by"] = bound(nbytes, 6 * b * h * p * n)
        timings[b] = t
        print(f"  ssd_update ({b}, {h}, {p}, {n}) x bf16: "
              f"{t['ms'] * 1e3:.2f} us, plain {t['plain_ms'] * 1e3:.2f} us, "
              f"library none, bound {t['bound_ms'] * 1e3:.2f} us "
              f"({t['bound_by']})", flush=True)
        del sets
    return {"name": "ssd_update", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_update.cu",
            "replaces": "src/repro/kernels/ssd_update.py:50",
            "max_abs_err": err_path, **timings[4]}


def gmm_inputs(lead, g, k, n, dt, gen, bias=False):
    """x (lead, G*K) ~ N(0, 1) and w (G, K, N) at the model's fan-in
    scale 1/sqrt(K), so y is O(1) as in the unembedding."""
    x = torch.randn(tuple(lead) + (g * k,), generator=gen, device="cuda")
    w = torch.randn(g, k, n, generator=gen, device="cuda") / math.sqrt(k)
    b = torch.randn(g, n, generator=gen, device="cuda") if bias else None
    return x.to(dt), w.to(dt), None if b is None else b.to(dt)


def phase_check_grouped_matmul() -> dict:
    """grouped_matmul against grouped_matmul_ref at the Fed2 unembedding's
    shapes (x (M, 8*256), w (8, 256, 6288), M = 4 and 128, bf16 as at
    full width, and fp32), at each route's edges (M = 1, 8 | 9 ... 256)
    and on ragged ones (M, K and N off the tiles and stages, K longer
    than the ring, K or N off 16 bytes, an unaligned w, G = 1, a leading
    batch dimension, a bias); each case must launch through the route it
    names. Limits: 1e-4 sqrt(K) fp32 and 0.3 bf16, the reference's
    (tests/test_kernels.py). The stream and wgmma routes must repeat to
    the bit. Times at M = 4 (stream) and 128 (wgmma)."""
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels.grouped_matmul import (grouped_matmul,
                                                    grouped_matmul_ref)
    gen = torch.Generator(device="cuda").manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    g0, k0, n0 = 8, 256, 6288

    def check_one(name, route, lead, g, k, n, dt, bias=False,
                  misalign=False):
        """One case, which must launch through ``route``."""
        x, w, b = gmm_inputs(lead, g, k, n, dt, gen, bias)
        if misalign:
            buf = torch.empty(w.numel() + 1, dtype=dt, device="cuda")
            w2 = buf[1:].view(w.shape)
            w2.copy_(w)
            w = w2
        tol = 1e-4 * math.sqrt(k) if dt == f32 else 0.3
        before = dict(grouped_matmul.route_launches)
        got = grouped_matmul(x, w, b)
        ran = [r for r, c in grouped_matmul.route_launches.items()
               if c != before[r]]
        assert ran == [route], f"grouped_matmul {name}: ran {ran}, " \
            f"expected the {route} route"
        return check(f"grouped_matmul {name} [{route}] x {tuple(x.shape)} "
                     f"w {tuple(w.shape)}{' + bias' if bias else ''} "
                     f"{str(dt)[6:]}", got, grouped_matmul_ref(x, w, b), tol)

    err_path = max(check_one("serve path", "stream", (4,), g0, k0, n0, bf16),
                   check_one("serve path", "stream", (4,), g0, k0, n0, f32))
    check_one("decode_32k batch", "wgmma", (128,), g0, k0, n0, bf16)
    check_one("decode_32k batch", "simt", (128,), g0, k0, n0, f32)
    # each route's edges at the serve shape: M = 1 and 8 (stream), 9 to
    # 256 (wgmma: one ragged row tile, two, three)
    for m in (1, 8, 9, 64, 65, 129, 256):
        check_one("route edge", "stream" if m <= 8 else "wgmma", (m,), g0,
                  k0, n0, bf16)
    check_one("route edge", "stream", (8,), g0, k0, n0, f32)
    # the stream route: M <= 8, K and N multiples of 16 bytes, aligned;
    # K off a stage (64 bf16 / 32 fp32 rows: zero-filled past the group),
    # longer than the ring (4 stages), and N off the 96-column unit
    check_one("ragged", "stream", (3,), 3, 100, 68, f32, bias=True)
    check_one("K off a stage", "stream", (4,), 2, 104, 264, bf16)
    check_one("K past the ring", "stream", (4,), 2, 600, 264, bf16)
    check_one("long K", "stream", (6,), 2, 600, 132, f32)
    check_one("G = 1", "stream", (4,), 1, k0, n0, bf16)
    check_one("leading batch dim", "stream", (2, 3), 4, 64, 136, f32,
              bias=True)
    check_one("leading batch dim", "stream", (2, 1), g0, k0, n0, bf16,
              bias=True)
    # the wgmma route: M > 8 bf16, K and N multiples of 16 bytes; K past
    # the group zero-filled (104 = 64 + 40), K past the ring (600), N off
    # the 192-column tile
    check_one("ragged", "wgmma", (9,), 2, 64, 256, bf16)
    check_one("K off a stage", "wgmma", (64,), 3, 104, 200, bf16)
    check_one("K past the ring", "wgmma", (64,), 2, 600, 264, bf16)
    check_one("G = 1", "wgmma", (128,), 1, k0, n0, bf16)
    check_one("leading batch dim", "wgmma", (2, 64), g0, k0, n0, bf16,
              bias=True)
    # the simt route: what TMA does not take, and fp32 at M > 8
    check_one("ragged", "simt", (8,), 2, 33, 260, bf16)
    check_one("long K", "simt", (4,), 2, 600, 132, bf16)
    check_one("ragged", "simt", (5,), 3, 100, 70, f32, bias=True)
    check_one("ragged", "simt", (17,), 5, 13, 130, bf16, bias=True)
    check_one("ragged", "simt", (130,), 13, 13, 13, f32)
    check_one("ragged", "simt", (200,), 5, 100, 70, bf16)
    check_one("K off 16 bytes", "simt", (4,), 2, 100, 264, bf16)
    check_one("K off 16 bytes", "simt", (64,), 2, 100, 264, bf16)
    check_one("N off the vector width", "simt", (4,), 2, 64, 6289, bf16)
    check_one("unaligned w", "simt", (4,), 2, 64, 512, f32, misalign=True)
    check_one("unaligned w", "simt", (4,), 2, 64, 512, bf16, misalign=True)
    # the stream and wgmma routes repeat to the bit
    for m in (4, 128):
        x, w, _ = gmm_inputs((m,), g0, k0, n0, bf16, gen)
        assert torch.equal(grouped_matmul(x, w), grouped_matmul(x, w)), \
            f"grouped_matmul M={m}: two calls on the same inputs differ"

    timings = {}
    for m in (4, 128):
        esz = 2
        w_bytes = g0 * k0 * n0 * esz
        nbytes = w_bytes + esz * m * g0 * (k0 + n0)
        sets = [gmm_inputs((m,), g0, k0, n0, bf16, gen)[:2]
                for _ in range(copies_for(w_bytes))]
        reps = max(200, len(sets))
        t = {"ms": time_ms([lambda a=a: grouped_matmul(*a) for a in sets],
                           reps),
             "plain_ms": time_ms([lambda a=a: grouped_matmul_ref(*a)
                                  for a in sets], reps),
             "library_ms": time_ms([lambda a=a: torch.bmm(
                 a[0].view(m, g0, k0).transpose(0, 1), a[1])
                 for a in sets], reps)}
        t["bound_ms"], t["bound_by"] = bound(nbytes, 2 * m * g0 * k0 * n0,
                                             BF16_FLOPS)
        timings[m] = t
        print(f"  grouped_matmul M={m} (8, 256, 6288) bf16 "
              f"[{gm.route(m, g0, k0, n0, bf16, 0, 0)}]: "
              f"{t['ms'] * 1e3:.2f} us, plain {t['plain_ms'] * 1e3:.2f} us, "
              f"torch.bmm {t['library_ms'] * 1e3:.2f} us, bound "
              f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']})", flush=True)
        del sets
    return {"name": "grouped_matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/grouped_matmul.cu",
            "replaces": "src/repro/kernels/grouped_matmul.py:48",
            "max_abs_err": err_path, **timings[4]}


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


def wrappers() -> dict:
    """Every kernel's wrapper, by name: each carries its launch count."""
    from repro_torch.kernels.feature_stats import feature_stats
    from repro_torch.kernels.grouped_matmul import grouped_matmul
    from repro_torch.kernels.local_step import local_step
    from repro_torch.kernels.paired_fusion import paired_fusion
    from repro_torch.kernels.ssd_update import ssd_update
    return {"paired_fusion": paired_fusion, "local_step": local_step,
            "feature_stats": feature_stats, "grouped_matmul": grouped_matmul,
            "ssd_update": ssd_update}


def counted(label: str, run, expect: dict, gmm_routes: dict | None = None):
    """``run()`` with every launch counter set to 0 just before it and
    read just after; the counts must equal ``expect`` (a kernel it does
    not name must not launch), and grouped_matmul's launches by route
    ``gmm_routes`` (a route it does not name must not launch)."""
    fns = wrappers()
    gmm = fns["grouped_matmul"]
    expect = {**{k: 0 for k in fns}, **expect}
    expect_routes = {**{r: 0 for r in gmm.route_launches},
                     **(gmm_routes or {})}
    for f in fns.values():
        f.launches = 0
    for r in gmm.route_launches:
        gmm.route_launches[r] = 0
    out = run()
    counts = {k: f.launches for k, f in fns.items()}
    routes = dict(gmm.route_launches)
    print(f"  launches, {label}: {counts} (expected {expect}); "
          f"grouped_matmul by route {routes} (expected {expect_routes})",
          flush=True)
    assert counts == expect, f"{label}: launches {counts} != {expect}"
    assert routes == expect_routes, \
        f"{label}: grouped_matmul routes {routes} != {expect_routes}"
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
    from repro_torch.core.feature_stats import (class_preference_vectors,
                                                total_variance)
    from repro_torch.core.grouping import choose_decouple_depth
    from repro_torch.launch import auto_depth
    out, counts = counted(
        "auto_depth (full width)",
        lambda: auto_depth.run_auto_depth(device="cuda", log=print),
        {"paired_fusion": auto_depth.ROUNDS, "local_step": 0,
         "feature_stats": 1})
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

    def eq9(use_kernel):
        return class_preference_vectors(out["warm_params"], out["warm_cfg"],
                                        *out["probe"], use_kernel=use_kernel)

    with tf32_off(), deterministic_convs():
        on, off = eq9(True), eq9(False)
        tv_on = [float(total_variance(p)) for p in on]
        tv_off = [float(total_variance(p)) for p in off]
    err = max((a - b).abs().max().item() for a, b in zip(on, off))
    ok = all(torch.allclose(a, b, atol=PVEC_ATOL, rtol=PVEC_RTOL)
             for a, b in zip(on, off))
    print(f"  Eq. 9 on the warm model, feature_stats kernel vs plain "
          f"(TF32 off): max_abs_err {err:.3g} (atol {PVEC_ATOL:g}, rtol "
          f"{PVEC_RTOL:g}) {'ok' if ok else 'FAIL'}")
    assert ok, "Eq. 9 through the kernel disagrees with the plain route"
    depth = {k: max(choose_decouple_depth(tv, threshold_frac=0.5,
                                          min_shared=2), 1)
             for k, tv in (("kernel", tv_on), ("plain", tv_off))}
    print(f"  TV profile, kernel route {[round(t, 4) for t in tv_on]}, "
          f"plain route {[round(t, 4) for t in tv_off]}; decouple depth "
          f"{depth['kernel']} and {depth['plain']}")
    assert depth["kernel"] == depth["plain"], \
        "the kernel route chooses another decouple depth"
    # wall time of one Eq. 9 evaluation on the warm model (its C backward
    # passes included), the two routes in turns, as the path runs it
    walls = {True: [], False: []}
    for _ in range(5):
        for use_kernel in (True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eq9(use_kernel)
            torch.cuda.synchronize()
            walls[use_kernel].append(time.perf_counter() - t0)
    med = {k: sorted(v)[2] * 1e3 for k, v in walls.items()}
    print(f"  Eq. 9 wall time on the warm model, median of 5: kernel "
          f"route {med[True]:.2f} ms, plain route {med[False]:.2f} ms")
    return counts["feature_stats"]


def _category(name: str) -> str:
    n = name.lower()
    for cat, keys in (("paired_fusion", ("paired_fusion",)),
                      ("local_step", ("local_step",)),
                      ("ssd_update", ("ssd_update",)),
                      ("grouped_matmul", ("grouped_matmul",)),
                      ("memcpy/memset", ("memcpy", "memset")),
                      ("conv (cuDNN)", ("conv", "cudnn", "xmma", "implicit",
                                        "wgrad", "dgrad", "winograd")),
                      ("gemm", ("gemm", "gemv", "cutlass", "cublas",
                                "nvjet"))):
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


def free_device_memory():
    gc.collect()
    torch.cuda.empty_cache()


def serve_cli(*extra):
    """The serving CLI (``python -m repro_torch.launch.serve``) with the
    reference's defaults plus ``extra``; checks its output and prints
    its times, peak device memory and parameter count."""
    from repro_torch.launch import serve
    argv = list(extra)
    print("  python -m repro_torch.launch.serve", " ".join(argv), flush=True)
    args = serve.parse_args(argv)
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    out = serve.main(argv)
    peak = torch.cuda.max_memory_allocated()
    toks, logits = out["tokens"], out["logits"]
    cfg = serve.config_of(args)
    assert toks.shape == (args.batch, args.gen), toks.shape
    assert ((toks >= 0) & (toks < cfg.vocab)).all(), "token out of range"
    assert logits.shape == (args.batch, 1, cfg.vocab) and logits.is_cuda
    assert bool(torch.isfinite(logits).all()), "non-finite logits"
    want = SERVE_PARAMS[args.fed2_groups]
    print(f"  -> prefill {args.prompt_len} tok x {args.batch} in "
          f"{out['prefill_s']:.3f} s ({args.prompt_len * args.batch / out['prefill_s']:.1f} tok/s), "
          f"decode {args.gen} tok x {args.batch} in {out['decode_s']:.3f} s "
          f"({out['tok_s']:.1f} tok/s); peak device memory "
          f"{peak / 2 ** 30:.2f} GiB; {out['param_count']:,} parameters "
          f"(reference: {want:,})", flush=True)
    assert out["param_count"] == want, "parameter count differs from the " \
        "reference's"
    del out
    free_device_memory()
    return peak


def phase_serve() -> dict:
    """Returns the launch counts of the run that takes both kernels."""
    from repro_torch.launch import serve
    d = serve.parse_args([])
    steps = d.prompt_len + d.gen
    ssd = SERVE_LAYERS * steps
    counted("serve --full", lambda: serve_cli("--full"),
            {"ssd_update": ssd})
    _, counts = counted(
        "serve --full --fed2-groups 8",
        lambda: serve_cli("--full", "--fed2-groups", "8"),
        {"ssd_update": ssd, "grouped_matmul": steps}, {"stream": steps})
    peak, _ = counted(
        "serve --full --fed2-groups 8 --batch 128 (decode_32k's batch)",
        lambda: serve_cli("--full", "--fed2-groups", "8", "--batch", "128",
                          "--prompt-len", "2", "--gen", "2"),
        {"ssd_update": SERVE_LAYERS * 4, "grouped_matmul": 4}, {"wgmma": 4})
    state = SERVE_LAYERS * 128 * 64 * 64 * 128 * 4
    print(f"  SSM state at batch 128: {state / 1e9:.1f} GB; peak "
          f"{peak / 1e9:.1f} GB", flush=True)
    assert peak > state, "the batch-128 run did not hold its SSM state"
    return counts


def phase_serve_profile():
    """A Fed2 serve at full width (batch 4, 8 prompt + 8 decoded tokens)
    under torch.profiler: device busy share of the wall time and device
    time by kernel category."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.configs.common import with_fed2
    from repro_torch.launch.serve import run_serve
    from repro_torch.models import transformer as tfm
    cfg = with_fed2(get_config("mamba2-1.3b"), groups=8)
    params = tfm.init_params(torch.Generator(device="cuda").manual_seed(0),
                             cfg)
    kw = dict(batch=4, prompt_len=8, gen=8, device="cuda",
              init_params=params)
    run_serve(cfg, **kw)                                    # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        out = run_serve(cfg, **kw)
        wall = time.time() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    total_us = sum(e.self_device_time_total for e in dev)
    steps = kw["prompt_len"] + kw["gen"]
    print(f"  {steps} serve steps: wall {wall * 1e3:.1f} ms "
          f"({wall * 1e3 / steps:.2f} ms/step; decode {out['tok_s']:.1f} "
          f"tok/s), device busy {total_us / 1e3:.1f} ms "
          f"({100 * total_us / 1e3 / wall / 1e3:.1f} %), "
          f"{sum(e.count for e in dev)} device ops")
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
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / 1e3:8.2f} ms x{e.count:<5d} "
              f"{e.key[:90]}")


def phase_decode_parity():
    """The full mamba2-1.3b with Fed2 (groups 8) in fp32, TF32 off: 8
    tokens through decode_step with the kernels and with the plain
    versions, from one init and two zeroed caches. The plain route must
    launch no kernel; logits (every step) and the final cache must agree
    within PARITY_LOGIT_ATOL and PARITY_STATE_RTOL (of each cache
    leaf's largest value)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.common import with_fed2
    from repro_torch.models import transformer as tfm
    from repro_torch.models.forward import decode_step, init_cache
    cfg = with_fed2(get_config("mamba2-1.3b", dtype=torch.float32), groups=8)
    params = tfm.init_params(torch.Generator(device="cuda").manual_seed(1),
                             cfg)
    bs, steps = 4, 8
    toks = torch.randint(0, cfg.vocab, (bs, steps), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(2))

    def run(use_kernel):
        cache = init_cache(cfg, bs, 128, device="cuda")
        logits = [decode_step(params, cfg, cache, toks[:, t:t + 1], t,
                              use_kernel=use_kernel)[0]
                  for t in range(steps)]
        return logits, cache

    (on, c_on), _ = counted(
        "decode parity, kernels", lambda: run(True),
        {"ssd_update": SERVE_LAYERS * steps, "grouped_matmul": steps},
        {"stream": steps})
    (off, c_off), _ = counted("decode parity, plain versions",
                              lambda: run(False), {})
    err_logits = max((a - b).abs().max().item() for a, b in zip(on, off))
    mag = max(b.abs().max().item() for b in off)
    errs = {k: (c_on["blocks"][k] - c_off["blocks"][k]).abs().max().item()
            for k in ("ssm", "conv")}
    lims = {k: PARITY_STATE_RTOL * c_off["blocks"][k].abs().max().item()
            for k in ("ssm", "conv")}
    ok = err_logits <= PARITY_LOGIT_ATOL and all(errs[k] <= lims[k]
                                                 for k in errs)
    print(f"  {steps} tokens, batch {bs}, fp32: max |dlogits| "
          f"{err_logits:.3g} (limit {PARITY_LOGIT_ATOL:g}; max |logit| "
          f"{mag:.3g}); final cache max |dh| {errs['ssm']:.3g} (limit "
          f"{lims['ssm']:.3g}), max |dconv| {errs['conv']:.3g} (limit "
          f"{lims['conv']:.3g}) {'ok' if ok else 'FAIL'}", flush=True)
    assert ok, "decode with the kernels drifts from the plain versions"


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
          "feature_stats.cu), grouped_matmul (cuda: src/repro_torch/csrc/"
          "grouped_matmul.cu), ssd_update (cuda: src/repro_torch/csrc/"
          "ssd_update.cu)", flush=True)
    layout = main_layout()
    with phase("check (TF32 off)"), tf32_off():
        records = [phase_check_paired_fusion(layout),
                   phase_check_local_step(layout),
                   phase_check_feature_stats(),
                   phase_check_grouped_matmul(),
                   phase_check_ssd_update()]
        for r in records:
            lib = ("none" if r["library_ms"] is None
                   else f"{r['library_ms'] * 1e3:.1f} us")
            print(f"  {r['name']}: {r['ms'] * 1e3:.1f} us, plain "
                  f"{r['plain_ms'] * 1e3:.1f} us, library {lib}, bound "
                  f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']})")
    free_device_memory()
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
    with phase("serve"):
        serve_counts = phase_serve()
    counts["grouped_matmul"] = serve_counts["grouped_matmul"]
    counts["ssd_update"] = serve_counts["ssd_update"]
    with phase("serve profile"):
        phase_serve_profile()
    free_device_memory()
    with phase("decode parity (TF32 off)"), tf32_off():
        phase_decode_parity()
    free_device_memory()
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
