"""grouped_matmul's plans on the card: the measurements behind PERF.md's
decoupled-FFN rows of ``grouped_matmul``, apart from ``chip_smoke.py``'s
own run. Needs a CUDA card; builds the kernels first.

    python3 tools/gmm_plans.py sweep          # every plan of each FFN product
    python3 tools/gmm_plans.py margin [ROUNDS]  # a split plan against unsplit
    python3 tools/gmm_plans.py rows OUT.json [TREE]
    python3 tools/gmm_plans.py same-bits A.json B.json

``rows`` runs the timed plan-(1, 192) rows through the ``repro_torch``
of TREE (default: this checkout), so that a checkout of an earlier
commit, unpacked into a gitignored directory, is measured in the same
call (parent, this, this, parent); ``same-bits`` then compares the
outputs' digests.
"""
from __future__ import annotations

import hashlib
import json
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


def rows(cs, save: str, this_tree: bool):
    """The check phase's timed grouped_matmul rows whose plan is
    ``DEFAULT_PLAN`` (every row but the decoupled FFN products), called
    through the wrapper alone: the sha256 of their outputs' bytes on
    seeded inputs goes to ``save`` (JSON) and their times are printed.
    In this checkout each row's plan is held to ``DEFAULT_PLAN``."""
    import torch
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels.grouped_matmul import grouped_matmul
    bf16, f32, g0 = torch.bfloat16, torch.float32, 8
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ffn = {(k, n) for _, k, n, _ in cs.GMM_FFN_PRODUCTS}
    todo = [(4, g0, 256, 6288, bf16), (128, g0, 256, 6288, bf16),
            (4096, g0, 256, 6288, bf16), (4096, 4, 512, 12576, f32),
            (4096, 4, 512, 32064, f32), (4096, 4, 640, 8000, f32),
            *((4096, 4, w["d_model"] // 4, w["vocab"] // 4, f32)
              for w in cs.MOE_FL.values()),
            (1024, g0, 256, 11584, f32),
            *((m, g0, k, n, bf16) for arch, k, n in cs.OTHER_GMM_SHAPES
              for m in (4, cs.OTHER_BIG_BATCH[arch]) if (k, n) not in ffn),
            *((m, g0, k, n, bf16) for _, k, n in cs.MOE_GMM_SHAPES
              for m in (4, 128)),
            *((m, g0, k, n, bf16) for _, k, n, _ in cs.FRONTEND_GMM_SHAPES
              for m in (4, 128) if (k, n) not in ffn)]
    outs = {}
    for m, g, k, n, dt in todo:
        if this_tree:
            r = gm.route(m, g, k, n, dt, 0, 0)
            assert gm.plan(r, m, g, k, n, sms, dt) == gm.DEFAULT_PLAN
        gen = torch.Generator(device="cuda").manual_seed(m * 7 + k + n)
        x, w, _ = cs.gmm_inputs((m,), g, k, n, dt, gen)
        y = grouped_matmul(x, w)
        bits = y.view(torch.int16 if dt == bf16 else torch.int32)
        outs[f"{(m, g, k, n, str(dt))}"] = hashlib.sha256(
            bits.cpu().numpy().tobytes()).hexdigest()
        del x, w, y, bits
        sets = [cs.gmm_inputs((m,), g, k, n, dt, gen)[:2]
                for _ in range(cs.copies_for(g * k * n * dt.itemsize))]
        ms = cs.time_ms([lambda a=a: grouped_matmul(*a) for a in sets],
                        max(200 if m <= 128 else 10, len(sets)))
        print(f"  unsplit row ({m}, {g}, {k}, {n}) {str(dt)[6:]}: "
              f"{ms * 1e3:.2f} us", flush=True)
        del sets
        cs.free_device_memory()
    Path(save).write_text(json.dumps(outs, indent=1))


def same_bits(a: str, b: str):
    """Whether two ``rows`` files hold the same bits."""
    ta, tb = json.loads(Path(a).read_text()), json.loads(Path(b).read_text())
    assert ta.keys() == tb.keys()
    for key in ta:
        assert ta[key] == tb[key], f"{key}: the bits differ"
    print(f"  {len(ta)} unsplit rows: the same bits in {a} and {b}")


def main(argv: list[str]) -> int:
    what, args = argv[0], argv[1:]
    if what == "same-bits":
        same_bits(*args)
        return 0
    if what == "rows":
        tree = Path(args[1]) if len(args) > 1 else None
        cs = _setup(tree)
        with cs.tf32_off():
            rows(cs, args[0], tree is None)
        return 0
    cs = _setup()
    with cs.tf32_off():
        if what == "sweep":
            sweep(cs)
        elif what == "margin":
            margin(cs, int(args[0]) if args else 3)
        else:
            raise SystemExit(__doc__)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
