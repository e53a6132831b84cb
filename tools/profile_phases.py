#!/usr/bin/env python3
"""The profiler phases of ``chip_smoke.py``, on their own.

    python3 tools/profile_phases.py              # all, one CUDA card
    python3 tools/profile_phases.py main serve   # some, by name

Each runs, under ``torch.profiler``, a path that a phase of
``chip_smoke.py`` drives and checks at full width, and prints the
card's busy share of the wall time and the device time by kernel
category (``chip_smoke.profiled``); the kernels are built first
(``chip_smoke.phase_build``). They are measurements only: they assert
nothing, and the profiler's host-side work (it grows with the operators
it records) took about 200 s of ``chip_smoke.py``'s 1,200 s there. The
phases, by name, with the ``chip_smoke.py`` phase whose path each
profiles:

- main: the CLI's main path, fed2 with --use-local-kernel, 3 rounds
  (phase 5);
- tiers_async: capacity-tier path A, 1 round, and async path C, 2
  events (phases 16 and 18);
- serve: a Mamba-2 1.3B Fed2 serve (phase 23);
- lm: the Mamba-2 --mode lm step at PROFILE_LM_LAYERS of 48 layers, +-
  --microbatches 2, and one fed2 LM round (phases 26 and 27);
- dense_lm: the llama --mode lm step (attention passes split out) and
  one fed2 dense LM round (phases 32 and 33);
- hybrid: zamba2 Fed2 decode steps at batch 4 and 128 (with
  ssd_update's device time) and its --mode lm step at PROFILE_LM_LAYERS
  of 54 layers (phases 35 and 37);
- moe: deepseek and mixtral Fed2 decode steps (layer 0's parts timed by
  CUDA events) and a deepseek --mode lm step (phases 40 and 42);
- frontend: Whisper and InternVL decode steps and a Whisper --mode lm
  step (phases 45 and 47).

Nothing here imports jax or ``repro``.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (  # noqa: E402
    ASYNC_PATH, BF16_FLOPS, FRONTEND_TRAIN, LM_FL, MOE_SERVE_LAYERS,
    MOE_TRAIN, TIER_PATHS, _category, bound, dense_fl_config, event_ms,
    free_device_memory, frontend_config, lm_fl_inputs, mamba_fl_config,
    moe_config, nvidia_smi, phase, phase_build, profiled)

# the profiled --mode lm steps of Mamba-2 and Zamba2 run at full width
# and this depth (Zamba2: 1 super-block): the profiler's cost grows with
# the device ops it records (~2 ms a op on the card's host: 145k ops
# made the lm profile phase 264 s), while a layer's ops and their shares
# are the same at any depth. chip_smoke.py's lm train phases time the
# full depth.
PROFILE_LM_LAYERS = 6


def phase_profile():
    """The main path (fed2, --use-local-kernel, 3 rounds) under
    torch.profiler."""
    from repro_torch.fl.runtime import run_federated
    from repro_torch.launch import train
    inputs = train.fl_inputs(train.parse_args(["--rounds", "3"]))
    profiled("3 rounds", lambda: run_federated(
        *inputs, use_local_kernel=True, device="cuda"))


def phase_tier_async_profile():
    """Path A (--use-local-kernel, 1 round) and path C (fed2,
    --use-local-kernel, 2 events) under torch.profiler (the profiler's
    cost on the host grows with the ops it records)."""
    from repro_torch.fl.runtime import run_federated
    from repro_torch.launch import train
    a = train.parse_args(list(TIER_PATHS["A"][0]) + ["--rounds", "1"])
    inputs = train.fl_inputs(a)
    profiled("path A, 1 round", lambda: run_federated(
        *inputs, use_local_kernel=True, device="cuda"))
    c = train.parse_args(["--method", "fed2", *ASYNC_PATH, "--rounds", "2"])
    inputs = train.fl_inputs(c)
    profiled("path C (fed2), 2 events", lambda: run_federated(
        *inputs, latency=c.latency, use_local_kernel=True, device="cuda"))


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


def phase_lm_profile():
    """One --mode lm step at full width and PROFILE_LM_LAYERS layers
    (LM_TRAIN's shapes, after a warm-up step), the same with
    --microbatches 2, and one fed2 LM round (LM_FL, with
    --use-local-kernel, after a warm-up run) under torch.profiler."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.common import with_fed2
    from repro_torch.data.synthetic import (lm_batch_from_tokens,
                                            make_token_dataset)
    from repro_torch.fl.runtime import FLConfig, lm_task, run_federated
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tfm
    cfg = with_fed2(dataclasses.replace(get_config("mamba2-1.3b"),
                                        n_layers=PROFILE_LM_LAYERS),
                    groups=8)
    params = tfm.init_params(torch.Generator(device="cuda").manual_seed(0),
                             cfg)
    step_fn, opt = make_train_step(cfg, lr=1e-3)
    state = opt.init(params)
    toks, _ = make_token_dataset(16, 1025, cfg.vocab, seed=0)
    b0, b1 = (lm_batch_from_tokens(toks[i:i + 8], device="cuda")
              for i in (0, 8))
    params, state, _ = step_fn(params, state, 0, b0)
    profiled(f"one --mode lm step ({PROFILE_LM_LAYERS} layers), batch 8 "
             "x 1024", lambda: step_fn(params, state, 1, b1))
    step_mb2, _ = make_train_step(cfg, lr=1e-3, microbatches=2)
    params, state, _ = step_mb2(params, state, 1, b1)
    profiled(f"one --mode lm --microbatches 2 step ({PROFILE_LM_LAYERS} "
             "layers), batch 8 x 1024", lambda: step_mb2(params, state, 2,
                                                         b0))
    del params, state
    free_device_memory()
    cfg, parts, get_batch, test, init = lm_fl_inputs(mamba_fl_config())
    fl = FLConfig(method="fed2", **{**LM_FL, "rounds": 1})

    def one_round():
        run_federated(lm_task(cfg), fl, parts, get_batch, test,
                      use_local_kernel=True, device="cuda",
                      init_params=init)

    one_round()
    profiled("one fed2 LM round (4 clients x 4 steps, eval)", one_round)
    del init
    free_device_memory()


def phase_dense_lm_profile():
    """One --mode lm step of the dense LM (DENSE_LM_TRAIN's shapes, after
    a warm-up step; the attention passes split out) and one fed2 round
    of its federation (LM_FL on dense_fl_config, with
    --use-local-kernel, after a warm-up run) under torch.profiler."""
    from repro_torch.configs import get_config
    from repro_torch.configs.common import with_fed2
    from repro_torch.data.synthetic import (lm_batch_from_tokens,
                                            make_token_dataset)
    from repro_torch.fl.runtime import FLConfig, lm_task, run_federated
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tfm
    cfg = with_fed2(get_config("llama3.2-1b"), groups=8)
    params = tfm.init_params(torch.Generator(device="cuda").manual_seed(0),
                             cfg)
    step_fn, opt = make_train_step(cfg, lr=1e-3)
    state = opt.init(params)
    toks, _ = make_token_dataset(16, 1025, cfg.vocab, seed=0)
    b0, b1 = (lm_batch_from_tokens(toks[i:i + 8], device="cuda")
              for i in (0, 8))
    params, state, _ = step_fn(params, state, 0, b0)
    profiled("one --mode lm --arch llama3.2-1b step, batch 8 x 1024",
             lambda: step_fn(params, state, 1, b1),
             (cfg.attn_q_chunk, cfg.attn_kv_chunk))
    del params, state
    free_device_memory()
    cfg, parts, get_batch, test, init = lm_fl_inputs(dense_fl_config())
    fl = FLConfig(method="fed2", **{**LM_FL, "rounds": 1})

    def one_round():
        run_federated(lm_task(cfg), fl, parts, get_batch, test,
                      use_local_kernel=True, device="cuda",
                      init_params=init)

    one_round()
    # the warm-up run's engine holds reference cycles (its buffers,
    # ~20 GB at this width) until a collection
    free_device_memory()
    # no attention split here: with record_shapes the profiled vmapped
    # round kept its memory until it ran out of the card's 80 GB (from
    # 2.1 GiB allocated at its start); its score tiles are 64 x 64
    profiled("one fed2 dense LM round (4 clients x 4 steps, eval)",
             one_round)
    del init
    free_device_memory()


def phase_other_profile():
    """zamba2-2.7b with Fed2 (groups 8), bf16, at full width under
    torch.profiler: one decode step at full depth and batch 4, and one
    at batch 128 (each over 128 slots, after 8 warm-up steps; with
    ssd_update's device time), and one --mode lm step at
    PROFILE_LM_LAYERS layers and batch 8 x 1024 (after a warm-up
    step)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.common import with_fed2
    from repro_torch.data.synthetic import (lm_batch_from_tokens,
                                            make_token_dataset)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tfm
    from repro_torch.models.forward import decode_step, init_cache
    cfg = with_fed2(get_config("zamba2-2.7b"), groups=8)
    params = tfm.init_params(torch.Generator(device="cuda").manual_seed(0),
                             cfg)
    cache = init_cache(cfg, 4, 128, device="cuda")
    toks = torch.randint(0, cfg.vocab, (4, 9), device="cuda")
    with torch.no_grad():
        for t in range(8):
            decode_step(params, cfg, cache, toks[:, t:t + 1], t)
        profiled("one zamba2-2.7b Fed2 decode step, batch 4",
                 lambda: decode_step(params, cfg, cache, toks[:, 8:9], 8),
                 kernel="ssd_update")
        del cache
        cache = init_cache(cfg, 128, 128, device="cuda")
        toks = torch.randint(0, cfg.vocab, (128, 9), device="cuda")
        for t in range(8):
            decode_step(params, cfg, cache, toks[:, t:t + 1], t)
        profiled("one zamba2-2.7b Fed2 decode step, batch 128",
                 lambda: decode_step(params, cfg, cache, toks[:, 8:9], 8),
                 kernel="ssd_update")
    del cache, params
    cfg = dataclasses.replace(cfg, n_layers=PROFILE_LM_LAYERS)
    params = tfm.init_params(torch.Generator(device="cuda").manual_seed(0),
                             cfg)
    step_fn, opt = make_train_step(cfg, lr=1e-3)
    state = opt.init(params)
    data, _ = make_token_dataset(16, 1025, cfg.vocab, seed=0)
    b0, b1 = (lm_batch_from_tokens(data[i:i + 8], device="cuda")
              for i in (0, 8))
    params, state, _ = step_fn(params, state, 0, b0)
    profiled(f"one --mode lm --arch zamba2-2.7b step ({PROFILE_LM_LAYERS} "
             "layers), batch 8 x 1024", lambda: step_fn(params, state, 1,
                                                        b1))
    del params, state
    free_device_memory()


def moe_decode_parts(cfg, params, cache, pos):
    """CUDA-event times of a Fed2 decode step's parts at ``cache``'s
    batch, on ``blocks``' layer 0 at ``pos`` (its cache slot rewritten
    with the same values): the pre-norm and attention, the pre-norm and
    experts (drop-free: every expert over n·k rows), the whole block;
    with the expert products' bound (the experts' bf16 weights read
    once, or their FLOPs at the bf16 tensor-core peak)."""
    from repro_torch.models import attention as attn
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tfm
    from repro_torch.models.module import tree_leaves, tree_map
    p = tree_map(lambda t: t[0], params["blocks"])
    c = tree_map(lambda t: t[0], cache["blocks"])
    n = tree_leaves(cache)[0].shape[1]
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(n, 1, cfg.d_model, generator=gen, device="cuda",
                    dtype=cfg.dtype)

    def attention():
        h = tfm._norm_apply(cfg, p["ln1"], x)
        if cfg.mla_cfg:
            return attn.mla_decode(p["attn"], h, c, cfg.mla_cfg, pos=pos)
        return attn.gqa_decode(p["attn"], h, c, cfg.attn_cfg, pos=pos)

    def experts():
        return moe_lib.moe_apply(p["ffn"], tfm._norm_apply(cfg, p["ln2"], x),
                                 cfg.moe)

    t = {"attention": event_ms(attention, 5),
         "experts": event_ms(experts, 5),
         "block": event_ms(lambda: tfm.block_decode(p, x, c, cfg, pos=pos),
                           5)}
    m = cfg.moe
    wbytes = 3 * m.n_experts * m.d_model * m.d_ff_expert * 2
    flops = 6 * m.n_experts * n * m.top_k * m.d_model * m.d_ff_expert
    b, by = bound(wbytes, flops, BF16_FLOPS)
    print(f"  its layer 0 at batch {n} (CUDA events): attention "
          f"{t['attention']:.3f} ms, experts {t['experts']:.3f} ms (their "
          f"products' bound {b:.3f} ms, {by}: {wbytes / 1e9:.2f} GB, "
          f"{flops / 1e12:.2f} TFLOP over (E, n·k) = ({m.n_experts}, "
          f"{n * m.top_k}) rows), the block {t['block']:.3f} ms; x "
          f"{cfg.n_layers} layers {cfg.n_layers * t['block']:.1f} ms",
          flush=True)


def phase_moe_profile():
    """Under torch.profiler, after warm-up steps: one Fed2 decode step
    of each MoE arch at MOE_SERVE_LAYERS layers, batch 128 over 2048
    slots (the drop-free (E, n·k, d) dispatch buffers: (160, 768, 5120)
    and (8, 256, 6144)) and mixtral's at batch 4, each at batch 128 with
    its layer-0 parts timed (``moe_decode_parts``); and one --mode lm
    step of deepseek at MOE_TRAIN's cut (the MLA attention's passes
    split out)."""
    import dataclasses

    from repro_torch.data.synthetic import (lm_batch_from_tokens,
                                            make_token_dataset)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tfm
    from repro_torch.models.forward import decode_step, init_cache
    for arch, shapes in (("deepseek-v2-236b", ((128, 2048),)),
                         ("mixtral-8x22b", ((4, 128), (128, 2048)))):
        cfg = dataclasses.replace(moe_config(arch, 8),
                                  n_layers=MOE_SERVE_LAYERS)
        params = tfm.init_params(
            torch.Generator(device="cuda").manual_seed(0), cfg)
        for bs, max_len in shapes:
            cache = init_cache(cfg, bs, max_len, device="cuda")
            toks = torch.randint(0, cfg.vocab, (bs, 4), device="cuda")
            with torch.no_grad():
                for t in range(3):
                    decode_step(params, cfg, cache, toks[:, t:t + 1], t)
                profiled(f"one {arch} Fed2 decode step ({MOE_SERVE_LAYERS} "
                         f"layers), batch {bs} over {max_len} slots",
                         lambda: decode_step(params, cfg, cache,
                                             toks[:, 3:4], 3))
                if bs == 128:
                    moe_decode_parts(cfg, params, cache, 3)
            del cache
            free_device_memory()
        del params
        free_device_memory()
    arch = "deepseek-v2-236b"
    cfg = moe_config(arch, 8, **MOE_TRAIN[arch])
    params = tfm.init_params(torch.Generator(device="cuda").manual_seed(0),
                             cfg)
    step_fn, opt = make_train_step(cfg, lr=1e-3)
    state = opt.init(params)
    data, _ = make_token_dataset(16, 1025, cfg.vocab, seed=0)
    b0, b1 = (lm_batch_from_tokens(data[i:i + 8], device="cuda")
              for i in (0, 8))
    params, state, _ = step_fn(params, state, 0, b0)
    profiled(f"one --mode lm step, {arch} at {MOE_TRAIN[arch]}, batch 8 x "
             "1024", lambda: step_fn(params, state, 1, b1),
             attention_tile=(cfg.attn_q_chunk, cfg.attn_kv_chunk))
    del params, state
    free_device_memory()


def phase_frontend_profile():
    """Under torch.profiler, bf16 with Fed2 8 at full width and depth,
    after warm-up steps: one decode step of each arch at batch 4 over
    128 slots and Whisper's at batch 128 over 2048 slots (its cross
    cache (128, 1500, 8, 64)), and one Whisper --mode lm step at
    FRONTEND_TRAIN's batch (the chunked attention's passes split
    out); the decode steps list their costliest operators by input
    shapes."""
    from repro_torch.data.synthetic import (lm_batch_from_tokens,
                                            make_token_dataset)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tfm
    from repro_torch.models.forward import decode_step, init_cache
    for arch, shapes in (("whisper-base", ((4, 128), (128, 2048))),
                         ("internvl2-2b", ((4, 128),))):
        cfg = frontend_config(arch)
        params = tfm.init_params(
            torch.Generator(device="cuda").manual_seed(0), cfg)
        for bs, max_len in shapes:
            cache = init_cache(cfg, bs, max_len, device="cuda")
            toks = torch.randint(0, cfg.vocab, (bs, 4), device="cuda")
            with torch.no_grad():
                for t in range(4):
                    torch.cuda.synchronize()
                    t0 = time.time()
                    decode_step(params, cfg, cache, toks[:, t:t + 1], t)
                    torch.cuda.synchronize()
                print(f"  one {arch} Fed2 decode step unprofiled, batch {bs}"
                      f": {(time.time() - t0) * 1e3:.1f} ms")
                profiled(f"the same step, batch {bs} over {max_len} slots",
                         lambda: decode_step(params, cfg, cache,
                                             toks[:, 3:4], 3), top_ops=8)
            del cache
            free_device_memory()
        del params
        free_device_memory()
    arch = "whisper-base"
    cfg, kw = frontend_config(arch), FRONTEND_TRAIN[arch]
    params = tfm.init_params(torch.Generator(device="cuda").manual_seed(0),
                             cfg)
    step_fn, opt = make_train_step(cfg, lr=1e-3)
    state = opt.init(params)
    data, _ = make_token_dataset(3 * kw["batch"], kw["seq"] + 1, cfg.vocab,
                                 seed=0)
    gen = torch.Generator(device="cuda").manual_seed(4)
    batches = [lm_batch_from_tokens(data[i:i + kw["batch"]], device="cuda")
               for i in range(0, 3 * kw["batch"], kw["batch"])]
    for b in batches:
        b["embeds"] = torch.randn((kw["batch"], kw["embeds"], cfg.d_model),
                                  generator=gen, device="cuda",
                                  dtype=cfg.dtype)
    for i in range(2):
        params, state, _ = step_fn(params, state, i, batches[i])
    t0 = time.time()
    step_fn(params, state, 2, batches[2])
    torch.cuda.synchronize()
    print(f"  the same step unprofiled: {time.time() - t0:.3f} s")
    profiled(f"one --mode lm step, {arch}, batch {kw['batch']} x "
             f"{kw['seq']} tokens over {kw['embeds']} frames",
             lambda: step_fn(params, state, 2, batches[2]),
             attention_tile=(cfg.attn_q_chunk, cfg.attn_kv_chunk))
    del params, state
    free_device_memory()


PHASES = {"main": phase_profile, "tiers_async": phase_tier_async_profile,
          "serve": phase_serve_profile, "lm": phase_lm_profile,
          "dense_lm": phase_dense_lm_profile, "hybrid": phase_other_profile,
          "moe": phase_moe_profile, "frontend": phase_frontend_profile}


def main(argv=None) -> int:
    names = list(sys.argv[1:] if argv is None else argv) or list(PHASES)
    unknown = [n for n in names if n not in PHASES]
    if unknown:
        print(f"unknown phases {unknown}; choose from {list(PHASES)}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("profile_phases: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    print(f"  {nvidia_smi()}", flush=True)
    with phase("build"):
        phase_build()
    for n in names:
        with phase(f"{n} profile"):
            PHASES[n]()
            free_device_memory()
    return 0


if __name__ == "__main__":
    sys.exit(main())
