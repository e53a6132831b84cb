"""grouped_matmul's plans and designs on the card: the measurements behind
PERF.md's ``grouped_matmul`` rows beside ``chip_smoke.py``'s own run.
Needs a CUDA card; builds the kernels first.

    python3 tools/gmm_plans.py sweep          # every plan of each FFN product
    python3 tools/gmm_plans.py margin [ROUNDS]  # a split plan against unsplit
    python3 tools/gmm_plans.py widths         # every unsplit width, each row
    python3 tools/gmm_plans.py targets OUT.json [TREE]
    python3 tools/gmm_plans.py rows OUT.json [TREE]
    python3 tools/gmm_plans.py same-bits A.json B.json
    python3 tools/gmm_plans.py breakdown TREE OUT_DIR

``targets`` times the wgmma route's targeted rows (the M = 4096 eval
chunks, the M = 64-128 unembeddings) beside torch.bmm, the plain version
and the bound; ``widths`` each row the wgmma route runs on a path under
every unsplit width beside ``plan``'s choice. ``rows`` times every timed row of the check phase
through the ``repro_torch`` of TREE (default: this checkout), so that a
checkout of an earlier commit, unpacked into a gitignored directory, is
measured in the same call (parent, this, this, parent); ``same-bits``
then compares the outputs' digests. ``breakdown`` rebuilds TREE's
``grouped_matmul.cu`` with parts of its unsplit wgmma kernel taken out
or changed (``VARIANTS``: string edits of that source, a set for each
design, which must each apply once) into copies of TREE's ``src`` under
OUT_DIR and runs ``targets`` on each, so that the kernel's time is put
apart into loads, products and stores.
"""
from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _setup(tree: Path | None = None):
    """chip_smoke's helpers, with ``repro_torch`` taken from ``tree``'s
    src where given (imported before chip_smoke, which puts this
    checkout's src first)."""
    if tree is not None:
        sys.path.insert(0, str(tree.resolve() / "src"))
        import repro_torch  # noqa: F401
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    print(chip_smoke.nvidia_smi(), flush=True)
    if tree is None:                  # (another tree builds on first call)
        chip_smoke.phase_build()
    return chip_smoke


def sweep(cs, splits=(1, 2, 4, 8)):
    """Every plan of grouped_matmul's bf16 stream (M = 4; unsplit
    widths) and wgmma routes (the large-batch M; each width, and S of
    ``splits`` at 64 and 128 columns) on the decoupled FFN products
    (``GMM_FFN_PRODUCTS``) and at longer K (4096 and 8192 rows), timed
    in one call beside ``plan``'s choice and torch.bmm; each plan first
    held within 0.3 of the plain version and to its own bits on a
    relaunch, and an unsplit one to ``DEFAULT_PLAN``'s bits."""
    import torch
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels.grouped_matmul import grouped_matmul_ref
    gen = torch.Generator(device="cuda").manual_seed(7)
    bf16, g = torch.bfloat16, 8
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, k, n, big in (*cs.GMM_FFN_PRODUCTS, ("long K", 4096, 256, 128),
                             ("long K", 8192, 256, 128)):
        for m, r in ((4, "stream"), (big, "wgmma")):
            stages = -(-k // gm._STAGE_K[r])
            plans = [(sp, c) for c in gm._PLAN_COLS for sp in splits
                     if sp == 1 or (r == "wgmma" and sp <= stages
                                    and c in gm._SPLIT_COLS)]
            x, w, _ = cs.gmm_inputs((m,), g, k, n, bf16, gen)
            want = grouped_matmul_ref(x, w).float()
            base = gm.launch(x, w, r, gm.DEFAULT_PLAN)
            for p in plans:
                y = gm.launch(x, w, r, p)
                assert torch.equal(y, gm.launch(x, w, r, p)), (label, m, p)
                assert (y.float() - want).abs().max().item() <= 0.3, \
                    (label, m, p)
                assert p[0] > 1 or torch.equal(y, base), (label, m, p)
            w_bytes = g * k * n * 2
            sets = [cs.gmm_inputs((m,), g, k, n, bf16, gen)[:2]
                    for _ in range(cs.copies_for(w_bytes))]
            times = {p: cs.time_ms([lambda a=a, p=p: gm.launch(*a, r, p)
                                    for a in sets], 200) for p in plans}
            bmm = cs.time_ms([lambda a=a: torch.bmm(
                a[0].view(m, g, k).transpose(0, 1), a[1]) for a in sets], 200)
            bound_ms, _ = cs.bound(w_bytes + 2 * m * g * (k + n),
                                   2 * m * g * k * n, cs.BF16_FLOPS)
            best = min(times, key=times.get)
            chosen = gm.plan(r, m, g, k, n, sms)
            print(f"  sweep {label} ({g}, {k}, {n}) M={m} [{r}]: plan "
                  f"{chosen} {times[chosen] * 1e3:.2f} us, best {best} "
                  f"{times[best] * 1e3:.2f}, {gm.DEFAULT_PLAN} "
                  f"{times[gm.DEFAULT_PLAN] * 1e3:.2f}, torch.bmm "
                  f"{bmm * 1e3:.2f}, bound {bound_ms * 1e3:.2f}; "
                  + ", ".join(f"{p[0]}x{p[1]} {t * 1e3:.2f}"
                              for p, t in sorted(times.items())),
                  flush=True)
            del sets
            cs.free_device_memory()


def margin(cs, rounds: int = 3):
    """Each decoupled FFN product whose wgmma plan splits K (at its
    large-batch M), timed ``rounds`` times in one process under its
    plan, unsplit at the same width, under ``DEFAULT_PLAN`` and as
    torch.bmm, the four in turn; the split first held within 0.3 of the
    plain version and to its own bits, the unsplit width to
    ``DEFAULT_PLAN``'s bits."""
    import torch
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels.grouped_matmul import grouped_matmul_ref
    gen = torch.Generator(device="cuda").manual_seed(11)
    bf16, g = torch.bfloat16, 8
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, k, n, m in cs.GMM_FFN_PRODUCTS:
        p = gm.plan("wgmma", m, g, k, n, sms)
        if p[0] == 1:
            continue
        unsplit = (1, p[1])
        x, w, _ = cs.gmm_inputs((m,), g, k, n, bf16, gen)
        y = gm.launch(x, w, "wgmma", p)
        assert torch.equal(y, gm.launch(x, w, "wgmma", p)), label
        assert (y.float() - grouped_matmul_ref(x, w).float()).abs().max() \
            .item() <= 0.3, label
        assert torch.equal(gm.launch(x, w, "wgmma", unsplit),
                           gm.launch(x, w, "wgmma", gm.DEFAULT_PLAN)), label
        sets = [cs.gmm_inputs((m,), g, k, n, bf16, gen)[:2]
                for _ in range(cs.copies_for(g * k * n * 2))]
        fns = {f"plan {p}": lambda a, p=p: gm.launch(*a, "wgmma", p),
               f"plan {unsplit}": lambda a: gm.launch(*a, "wgmma", unsplit),
               f"plan {gm.DEFAULT_PLAN}":
                   lambda a: gm.launch(*a, "wgmma", gm.DEFAULT_PLAN),
               "torch.bmm": lambda a: torch.bmm(
                   a[0].view(m, g, k).transpose(0, 1), a[1])}
        for i in range(rounds):
            t = {name: cs.time_ms([lambda a=a, f=f: f(a) for a in sets], 200)
                 for name, f in fns.items()}
            split_ms, unsplit_ms = t[f"plan {p}"], t[f"plan {unsplit}"]
            print(f"  margin {label} (8, {k}, {n}) M={m}, round {i}: "
                  + ", ".join(f"{name} {ms * 1e3:.2f} us"
                              for name, ms in t.items())
                  + f"; split / unsplit {split_ms / unsplit_ms:.3f}",
                  flush=True)
        del sets
        cs.free_device_memory()


def rows(cs, save: str):
    """Every timed grouped_matmul row of the check phase, the decoupled FFN
    products (M = 4 and their large-batch M) and the bf16 eval chunks among
    them, called through the wrapper alone under the tree's own plan: the
    sha256 of each output's bytes on seeded inputs and its time go to
    ``save`` (JSON), the times are printed."""
    import torch
    from repro_torch.kernels.grouped_matmul import grouped_matmul
    bf16, f32, g0 = torch.bfloat16, torch.float32, 8
    todo = [(4, g0, 256, 6288, bf16), (128, g0, 256, 6288, bf16),
            *((cs.GMM_EVAL_M, g0, k, n, bf16)
              for _, k, n in cs.GMM_EVAL_CHUNKS),
            (cs.GMM_EVAL_M, *cs.GMM_LM_TASK_BF16, bf16),
            (4096, 4, 512, 12576, f32), (4096, 4, 512, 32064, f32),
            (4096, 4, 640, 8000, f32),
            *((4096, 4, w["d_model"] // 4, w["vocab"] // 4, f32)
              for w in cs.MOE_FL.values()),
            (1024, g0, 256, 11584, f32),
            *((m, g0, k, n, bf16) for _, k, n, big in cs.GMM_FFN_PRODUCTS
              for m in (4, big)),
            *((m, g0, k, n, bf16) for arch, k, n in cs.OTHER_GMM_SHAPES
              for m in (4, cs.OTHER_BIG_BATCH[arch])),
            *((m, g0, k, n, bf16) for _, k, n in cs.MOE_GMM_SHAPES
              for m in (4, 128)),
            *((m, g0, k, n, bf16) for _, k, n, _ in cs.FRONTEND_GMM_SHAPES
              for m in (4, 128))]
    outs = {}
    for m, g, k, n, dt in dict.fromkeys(todo):
        key = f"{(m, g, k, n, str(dt))}"
        gen = torch.Generator(device="cuda").manual_seed(m * 7 + k + n)
        x, w, _ = cs.gmm_inputs((m,), g, k, n, dt, gen)
        y = grouped_matmul(x, w)
        bits = y.view(torch.int16 if dt == bf16 else torch.int32)
        outs[key] = {"sha256": hashlib.sha256(
            bits.cpu().numpy().tobytes()).hexdigest()}
        del x, w, y, bits
        sets = [cs.gmm_inputs((m,), g, k, n, dt, gen)[:2]
                for _ in range(cs.copies_for(g * k * n * dt.itemsize))]
        outs[key]["ms"] = cs.time_ms(
            [lambda a=a: grouped_matmul(*a) for a in sets],
            max(200 if m <= 128 else 10, len(sets)))
        print(f"  row ({m}, {g}, {k}, {n}) {str(dt)[6:]}: "
              f"{outs[key]['ms'] * 1e3:.2f} us", flush=True)
        del sets
        cs.free_device_memory()
    Path(save).write_text(json.dumps(outs, indent=1))


def target_rows(cs) -> list:
    """(label, m, g, k, n) of the wgmma route's targeted rows: every LM's
    bf16 eval chunk (M = 4096) and the bf16 lm_task eval, then the
    unembeddings of the large-batch serve at M = 64-128."""
    m = cs.GMM_EVAL_M
    return [*((f"{arch} eval chunk", m, 8, k, n)
              for arch, k, n in cs.GMM_EVAL_CHUNKS),
            ("bf16 lm_task eval", m, *cs.GMM_LM_TASK_BF16),
            ("mamba2-1.3b unembedding", 128, 8, 256, 6288),
            ("h2o-danube-1.8b/zamba2-2.7b unembedding", 128, 8, 320, 4000),
            ("mixtral-8x22b unembedding", 128, 8, 768, 4096),
            ("stablelm-12b unembedding", 64, 8, 640, 12544)]


def targets(cs, save: str):
    """Each targeted row through the wrapper on seeded bf16 inputs: the
    sha256 of its output's bits, then its device time beside torch.bmm
    on (G, M, K), the plain version and the bound (graph replay over
    buffers of 3x L2), into ``save`` (JSON) and printed."""
    import torch
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels.grouped_matmul import (grouped_matmul,
                                                    grouped_matmul_ref)
    bf16 = torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for label, m, g, k, n in target_rows(cs):
        gen = torch.Generator(device="cuda").manual_seed(m * 7 + k + n)
        x, w, _ = cs.gmm_inputs((m,), g, k, n, bf16, gen)
        y = grouped_matmul(x, w)
        rec = {"shape": [m, g, k, n], "sha256": hashlib.sha256(
            y.view(torch.int16).cpu().numpy().tobytes()).hexdigest(),
            "max_abs_err": (y.float() - grouped_matmul_ref(x, w).float())
            .abs().max().item()}
        del x, w, y
        w_bytes = g * k * n * 2
        sets = [cs.gmm_inputs((m,), g, k, n, bf16, gen)[:2]
                for _ in range(cs.copies_for(w_bytes))]
        reps = max(200 if m <= 128 else 10, len(sets))
        rec["ms"] = cs.time_ms([lambda a=a: grouped_matmul(*a)
                                for a in sets], reps)
        rec["bmm_ms"] = cs.time_ms([lambda a=a: torch.bmm(
            a[0].view(m, g, k).transpose(0, 1), a[1]) for a in sets], reps)
        rec["plain_ms"] = cs.time_ms([lambda a=a: grouped_matmul_ref(*a)
                                      for a in sets], reps)
        rec["bound_ms"], rec["bound_by"] = cs.bound(
            w_bytes + 2 * m * g * (k + n), 2 * m * g * k * n, cs.BF16_FLOPS)
        rec["plan"] = list(gm.plan("wgmma", m, g, k, n, sms))
        out[label] = rec
        print(f"  target {label} ({m}, {g}, {k}, {n}) [plan "
              f"{tuple(rec['plan'])}]: {rec['ms'] * 1e3:.2f} us, torch.bmm "
              f"{rec['bmm_ms'] * 1e3:.2f}, plain {rec['plain_ms'] * 1e3:.2f}, "
              f"bound {rec['bound_ms'] * 1e3:.2f} ({rec['bound_by']}, "
              f"{100 * rec['bound_ms'] / rec['ms']:.1f} % of it), "
              f"max_abs_err {rec['max_abs_err']:.3g}", flush=True)
        del sets
        cs.free_device_memory()
    Path(save).write_text(json.dumps(out, indent=1))


def widths(cs):
    """Every unsplit wgmma width (_WGMMA_COLS) at each row the wgmma route
    runs on a path: the targeted rows, the decoupled FFN products at their
    large-batch M and the other unembeddings at M = 128; each width first
    held within 0.3 of the plain version and to ``DEFAULT_PLAN``'s bits,
    then timed in one process beside ``plan``'s choice (a split one too)
    and torch.bmm."""
    import torch
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels.grouped_matmul import grouped_matmul_ref
    bf16 = torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    todo = [*target_rows(cs),
            *((label, m, 8, k, n) for label, k, n, m in cs.GMM_FFN_PRODUCTS),
            *((f"{arch} unembedding", 128, 8, k, n)
              for arch, k, n in (("qwen2-7b", 448, 19008),
                                 *cs.MOE_GMM_SHAPES[1:],
                                 ("internvl2-2b", 256, 11584),
                                 ("llama3.2-1b", 256, 16032)))]
    for label, m, g, k, n in todo:
        gen = torch.Generator(device="cuda").manual_seed(m + k + n)
        x, w, _ = cs.gmm_inputs((m,), g, k, n, bf16, gen)
        want = grouped_matmul_ref(x, w).float()
        base = gm.launch(x, w, "wgmma", gm.DEFAULT_PLAN)
        for c in gm._WGMMA_COLS:
            y = gm.launch(x, w, "wgmma", (1, c))
            assert torch.equal(y, base), (label, c)
            assert (y.float() - want).abs().max().item() <= 0.3, (label, c)
        del x, w, want, base, y
        chosen = gm.plan("wgmma", m, g, k, n, sms)
        plans = [(1, c) for c in gm._WGMMA_COLS]
        plans += [chosen] if chosen not in plans else []
        sets = [cs.gmm_inputs((m,), g, k, n, bf16, gen)[:2]
                for _ in range(cs.copies_for(g * k * n * 2))]
        reps = max(200 if m <= 128 else 10, len(sets))
        times = {p: cs.time_ms([lambda a=a, p=p: gm.launch(
            *a, "wgmma", p) for a in sets], reps) for p in plans}
        bmm = cs.time_ms([lambda a=a: torch.bmm(
            a[0].view(m, g, k).transpose(0, 1), a[1]) for a in sets], reps)
        best = min(times, key=times.get)
        print(f"  widths {label} ({m}, {g}, {k}, {n}): plan {chosen} "
              f"{times[chosen] * 1e3:.2f} us, best {best} "
              f"{times[best] * 1e3:.2f}, torch.bmm {bmm * 1e3:.2f}; "
              + ", ".join(f"{p} {t * 1e3:.2f}" for p, t in times.items())
              + "; every width = plan (1, 192)'s bits", flush=True)
        del sets
        cs.free_device_memory()


# Edits of the unsplit wgmma kernel for ``breakdown``, one set for each
# design: one 128 x 192 tile a block at a time (commit 9c3c228), and the
# current one (row-tile pairs, 256 columns). Each (old, new) must occur
# once in the source; the first set whose edits all apply is run.
_NO_STORE = [("""        hopper::tma_store_3d(&ymap, ys + j * kYBox, nt * BN + j * 64, g,
                             mt * BM);
""", "")]
_NO_PRODUCTS = [("""      wgmma_bf16<BN>(acc, hopper::desc_sw128(a + kk * 32, 16, 1024),
                     hopper::desc_sw128(b + kk * 2048, kBBox, 1024));
""", "      (void)a;\n      (void)b;\n")]
_NO_LOADS = [("""    hopper::mbar_arrive_expect_tx(&full[s], kStageBytes);
    hopper::tma_load_3d(st, &xmap, &full[s], kb * BK, g, mt * BM);
#pragma unroll
    for (int j = 0; j < BN / 64; ++j) {
      hopper::tma_load_3d(st + kABytes + j * kBBox, &wmap, &full[s],
                          nt * BN + j * 64, kb * BK, g);
    }
""", "    (void)st;\n    hopper::mbar_arrive(&full[s]);\n")]
_NO_STORE_2 = [("""            hopper::tma_store_3d(&ymap, buf, col, tl.g, y_row);
""", "")]
_NO_PRODUCTS_2 = [("""          wgmma_bf16<BN>(acc, hopper::desc_sw128(a + kk * 32, 16, 1024),
                         hopper::desc_sw128(b + kk * 2048, kBBox, 1024));
""", "          (void)a;\n          (void)b;\n")]
_NO_LOADS_2 = [("""          hopper::mbar_arrive_expect_tx(&full[s], L::kStageBytes);
          hopper::tma_load_3d(st, &xmap, &full[s], kb * BK, tl.g, mt * BM);
#pragma unroll
          for (int j = rank; j < BN / 64; j += CM) {
            if constexpr (CM == 1) {
              hopper::tma_load_3d(st + kABytes + j * kBBox, &wmap, &full[s],
                                  tl.nt * BN + j * 64, kb * BK, tl.g);
            } else {
              hopper::tma_load_3d_multicast(
                  st + kABytes + j * kBBox, &wmap, &full[s],
                  tl.nt * BN + j * 64, kb * BK, tl.g, (1u << CM) - 1);
            }
          }
""", "          (void)st;\n          (void)mt;\n"
     "          hopper::mbar_arrive(&full[s]);\n")]
VARIANTS = {
    "one tile a block": {
        "as is": [],
        "no TMA store": _NO_STORE,
        "no products": _NO_PRODUCTS,
        "wgmma_wait<1>": [("""    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }
}
""", """    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    __syncwarp();
    if (ks > 0 && lane == 0) {
      hopper::mbar_arrive(&empty[(it - 1) % kStages]);
    }
  }
  hopper::wgmma_wait<0>();
  __syncwarp();
  if (nk > 0 && lane == 0) hopper::mbar_arrive(&empty[(it - 1) % kStages]);
}
""")],
        "loads only": _NO_PRODUCTS + _NO_STORE,
        "no loads": _NO_LOADS,
        "products only": _NO_LOADS + _NO_STORE,
        "M fastest": [("""                                   t / tiles_n % tiles_m, t % tiles_n,
""", """                                   t % tiles_m, t / tiles_m % tiles_n,
"""), ("""    const int mt = t / tiles_n % tiles_m;
    const int nt = t % tiles_n;
    float acc[BN / 2];
""", """    const int mt = t % tiles_m;
    const int nt = t / tiles_m % tiles_n;
    float acc[BN / 2];
""")],
    },
    "row-tile pairs": {
        "as is": [],
        "no TMA store": _NO_STORE_2,
        "no products": _NO_PRODUCTS_2,
        "no loads": _NO_LOADS_2,
        "loads only": _NO_PRODUCTS_2 + _NO_STORE_2,
        "products only": _NO_LOADS_2 + _NO_STORE_2,
        "wgmma_wait<0>": [("""        hopper::wgmma_wait<1>();
        if (ks > 0) release_slot<CM>(empty, (it - 1) % kStages, lane);
      }
      hopper::wgmma_wait<0>();
      release_slot<CM>(empty, (it - 1) % kStages, lane);
""", """        hopper::wgmma_wait<0>();
        release_slot<CM>(empty, s, lane);
      }
""")],
        "wgmma_wait<2>": [("""        hopper::wgmma_wait<1>();
        if (ks > 0) release_slot<CM>(empty, (it - 1) % kStages, lane);
      }
      hopper::wgmma_wait<0>();
""", """        hopper::wgmma_wait<2>();
        if (ks > 1) release_slot<CM>(empty, (it - 2) % kStages, lane);
      }
      hopper::wgmma_wait<0>();
      if (nk > 1) release_slot<CM>(empty, (it - 2) % kStages, lane);
""")],
        "no pairs": [("  const bool pairs = m > BM;\n",
                      "  const bool pairs = false;\n")],
        "N fastest": [(
            "  return {t / (tiles_m * tiles_n), t % tiles_m, t / tiles_m % "
            "tiles_n};\n",
            "  return {t / (tiles_m * tiles_n), t / tiles_n % tiles_m, t % "
            "tiles_n};\n")],
    },
}


def breakdown(tree: Path, out_dir: Path):
    """Builds each of ``VARIANTS`` from ``tree``'s source into a copy of
    its ``src`` under ``out_dir`` (the builds in parallel), then runs
    ``targets`` in each copy, one process each; a variant that
    does not build is reported and skipped."""
    src = (tree / "src/repro_torch/csrc/grouped_matmul.cu").read_text()
    design, variants = next(
        (d, v) for d, v in VARIANTS.items()
        if all(src.count(old) == 1 for e in v.values() for old, _ in e))
    print(f"  breakdown of the {design} design", flush=True)
    trees = {}
    for i, (name, edits) in enumerate(variants.items()):
        text = src
        for old, new in edits:
            text = text.replace(old, new)
        vt = out_dir / f"v{i}"
        shutil.rmtree(vt, ignore_errors=True)
        shutil.copytree(tree / "src", vt / "src", ignore=shutil.ignore_patterns(
            "_build", "__pycache__"))
        (vt / "src/repro_torch/csrc/grouped_matmul.cu").write_text(text)
        trees[name] = vt
    builds = {name: subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from repro_torch.kernels import build; "
         "build.build('grouped_matmul')", str(vt / "src")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, vt in trees.items()}
    for name, proc in builds.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"  breakdown {name}: the build failed\n{log[-3000:]}",
                  flush=True)
            del trees[name]
    for name, vt in trees.items():
        print(f"  breakdown {name}:", flush=True)
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "targets", str(out_dir / f"{vt.name}.json"), str(vt)],
                       check=False)


def same_bits(a: str, b: str):
    """Whether two ``rows`` files hold the same bits."""
    ta, tb = json.loads(Path(a).read_text()), json.loads(Path(b).read_text())
    assert ta.keys() == tb.keys()
    for key in ta:
        assert ta[key]["sha256"] == tb[key]["sha256"], \
            f"{key}: the bits differ"
    print(f"  {len(ta)} rows: the same bits in {a} and {b}")


def main(argv: list[str]) -> int:
    what, args = argv[0], argv[1:]
    if what == "same-bits":
        same_bits(*args)
        return 0
    if what == "rows":
        cs = _setup(Path(args[1]) if len(args) > 1 else None)
        with cs.tf32_off():
            rows(cs, args[0])
        return 0
    if what == "targets":
        tree = Path(args[1]) if len(args) > 1 else None
        targets(_setup(tree), args[0])
        return 0
    if what == "breakdown":
        breakdown(Path(args[0]), Path(args[1]))
        return 0
    cs = _setup()
    with cs.tf32_off():
        if what == "sweep":
            sweep(cs)
        elif what == "margin":
            margin(cs, int(args[0]) if args else 3)
        elif what == "widths":
            widths(cs)
        else:
            raise SystemExit(__doc__)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
