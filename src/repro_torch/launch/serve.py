"""Serving launcher: batched prefill by repeated decode, then greedy or
sampled token-by-token decode. The port of ``repro.launch.serve``.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --full --fed2-groups 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \
      --full --fed2-groups 8

It takes the reference's flags and defaults (``--arch llama3.2-1b
--batch 4 --prompt-len 32 --gen 16 --max-len 128 --temperature 0 --seed
0``) and serves the reduced config, as the reference does. Two flags are
added: ``--full`` serves the full config (``get_config(reduced=False)``)
and ``--fed2-groups G`` applies ``with_fed2(cfg, groups=G)``; together
they give the config the reference's ``launch/dryrun.py --fed2`` lowers.
Weights are random from ``--seed``, drawn on the serving device. On the
card a Fed2 unembedding runs the ``grouped_matmul`` kernel every step,
and so do a Fed2 llama's decoupled FFNs (three products a decoupled
block); every Mamba-2 layer runs the ``ssd_update`` kernel. Runs on the
CUDA card unless ``--device cpu`` is given. Sampling (``--temperature >
0``) draws from a ``torch.Generator`` seeded with ``--seed``, so its
tokens differ from the reference's ``jax.random`` draws.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_serve(cfg, *, batch: int = 4, prompt_len: int = 32, gen: int = 16,
              max_len: int = 128, temperature: float = 0.0, seed: int = 0,
              device=None, init_params=None):
    """Serve ``batch`` random prompts of ``prompt_len`` tokens (numpy
    ``default_rng(seed)``, as the reference draws them) and decode
    ``gen`` tokens each. ``init_params`` (a tree on ``device``) replaces
    the random init. Returns {tokens (batch, gen) numpy, logits of the
    last step, prefill_s, decode_s, tok_s, param_count}."""
    from repro_torch.fl.runtime import resolve_device
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import transformer as tfm
    from repro_torch.models.forward import init_cache
    from repro_torch.models.module import param_count
    if prompt_len < 1 or gen < 0 or batch < 1:
        raise ValueError("run_serve needs batch >= 1, prompt_len >= 1 and "
                         "gen >= 0")
    device = resolve_device(device)
    params = init_params if init_params is not None else tfm.init_params(
        torch.Generator(device=device).manual_seed(seed), cfg)
    serve_step = make_serve_step(cfg)
    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, size=(batch, prompt_len)), device=device)

    cache = init_cache(cfg, batch, max_len, device=device)
    _sync(device)
    t0 = time.perf_counter()
    # prefill via repeated decode (exercises the serve path end to end)
    for t in range(prompt_len):
        logits, cache = serve_step(params, cache, prompts[:, t:t + 1], t)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    out = []
    sampler = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    for t in range(prompt_len, prompt_len + gen):
        if temperature > 0:
            probs = torch.softmax(logits[:, 0].float() / temperature, -1)
            nxt = torch.multinomial(probs, 1, generator=sampler)
        else:
            nxt = logits[:, 0].argmax(-1, keepdim=True)
        out.append(nxt[:, 0])
        logits, cache = serve_step(params, cache, nxt, t)
    _sync(device)
    t_decode = time.perf_counter() - t0
    toks = (torch.stack(out, 1).cpu().numpy() if out
            else np.zeros((batch, 0), np.int64))
    return {"tokens": toks, "logits": logits, "prefill_s": t_prefill,
            "decode_s": t_decode,
            "tok_s": gen * batch / max(t_decode, 1e-9),
            "param_count": param_count(params)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="serve the full config (default: reduced, as "
                         "the reference)")
    ap.add_argument("--fed2-groups", type=int, default=0,
                    help="apply with_fed2(cfg, groups=G): a block-diagonal "
                         "unembedding over G vocab clusters (and a dense "
                         "LM's decoupled grouped-FFN blocks)")
    ap.add_argument("--device", default=None,
                    help="torch device; default = the CUDA card (fails "
                         "without one), 'cpu' to run on the CPU")
    return ap.parse_args(argv)


def config_of(args):
    from repro_torch.configs import get_config
    from repro_torch.configs.common import with_fed2
    cfg = get_config(args.arch, reduced=not args.full)
    return with_fed2(cfg, groups=args.fed2_groups) if args.fed2_groups \
        else cfg


def main(argv=None):
    args = parse_args(argv)
    cfg = config_of(args)
    out = run_serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                    gen=args.gen, max_len=args.max_len,
                    temperature=args.temperature, seed=args.seed,
                    device=args.device)
    print(f"arch={cfg.arch_id} prefill {args.prompt_len} tok in "
          f"{out['prefill_s']:.2f}s; decoded {args.gen} tok in "
          f"{out['decode_s']:.2f}s ({out['tok_s']:.1f} tok/s)")
    print("sample token ids:", out["tokens"][0][:12])
    return out


if __name__ == "__main__":
    main()
