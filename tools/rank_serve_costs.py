#!/usr/bin/env python3
"""Where a sharded decode step's time goes on ranks that share one card.

    python3 tools/rank_serve_costs.py        # one CUDA card

Two gloo ranks on a (1, 2) mesh, both on cuda:0 (``launch/mesh.spawn``),
as ``chip_smoke.py``'s ranks serve phase runs them. Each rank measures:

- the wall of one collective of ``launch/collectives.py`` at the decode
  step's sizes (an all-reduce of (4, 2048) bf16, an all-gather of (4,
  2176) bf16, an all-to-all of (2, 4, 16, 32) bf16), on CUDA tensors
  (staged through the host) and on CPU tensors (gloo alone), and the
  wall of one device-to-host copy of 64 B (a synchronisation);
- the wall of a decode step of the full Fed2 llama3.2-1b (bf16, batch
  4, its 16-token prompt) through run_serve(mesh=): on the real mesh,
  and on a dry mesh of the same shape (``make_dry_rank_mesh``: the
  same program, its collectives counted and moved nowhere);

and one process on the card serves the same prompt (no mesh). The
kernels are built first (``chip_smoke.phase_build``). Measurements
only: nothing is asserted, and the dry mesh's logits are not the
model's. Nothing here imports jax or ``repro``.
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

ARCH, GROUPS = "llama3.2-1b", 8
SERVE = dict(batch=4, prompt_len=16, gen=0, max_len=128, seed=0)


def wall_us(fn, n: int) -> float:
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def step_ms(cfg, full, mesh) -> float:
    """A decode step's wall (ms) over the prompt, after a warm-up
    serve."""
    from repro_torch.launch import serve
    serve.run_serve(cfg, device="cuda", init_params=full, mesh=mesh,
                    **SERVE)
    out = serve.run_serve(cfg, device="cuda", init_params=full, mesh=mesh,
                          **SERVE)
    return out["prefill_s"] / SERVE["prompt_len"] * 1e3


def rank_costs(mesh) -> dict:
    from repro_torch.launch import collectives as col
    from repro_torch.launch.mesh import make_dry_rank_mesh
    from repro_torch.models import transformer as tfm
    out = {}
    for dev in ("cuda", "cpu"):
        t = torch.zeros(4, 2048, dtype=torch.bfloat16, device=dev)
        g = torch.zeros(4, 2176, dtype=torch.bfloat16, device=dev)
        a = torch.zeros(2, 4, 16, 32, dtype=torch.bfloat16, device=dev)
        out[dev] = {
            "all_reduce_us": wall_us(lambda: col.all_reduce(t, mesh,
                                                            "model"), 300),
            "all_gather_us": wall_us(lambda: col.all_gather(g, mesh,
                                                            "model"), 300),
            "all_to_all_us": wall_us(lambda: col.all_to_all(a, mesh,
                                                            "model"), 300)}
    x = torch.zeros(16, device="cuda")
    out["d2h_sync_us"] = wall_us(lambda: x.cpu(), 300)
    cfg = chip_smoke.ranks_serve_config(ARCH, GROUPS)
    full = tfm.init_params(torch.Generator(device="cuda").manual_seed(
        SERVE["seed"]), cfg)
    out["step_ms"] = step_ms(cfg, full, mesh)
    out["dry_step_ms"] = step_ms(cfg, full, make_dry_rank_mesh(
        (1, 2), mesh.rank, device="cuda"))
    return out


def main() -> int:
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import transformer as tfm
    chip_smoke.phase_build()
    print(f"{chip_smoke.nvidia_smi()}; {os.cpu_count()} host cores",
          flush=True)
    for r, c in enumerate(spawn(rank_costs, (1, 2), backend="gloo",
                                device="cuda", timeout=600)):
        print(f"rank {r}: {c}", flush=True)
    cfg = chip_smoke.ranks_serve_config(ARCH, GROUPS)
    full = tfm.init_params(torch.Generator(device="cuda").manual_seed(
        SERVE["seed"]), cfg)
    print(f"one process: decode step {step_ms(cfg, full, None):.1f} ms "
          f"({ARCH} fed2 {GROUPS}, batch {SERVE['batch']})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
