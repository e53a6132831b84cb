"""Batched serving example: decode with KV/SSM caches across
architecture families (dense GQA, SWA ring buffer, MLA latent cache, SSD
state), the executable counterpart of the decode dry-runs. The port of
the reference's ``examples/serve_decode.py``, with its flags and
defaults.

  PYTHONPATH=src python -m repro_torch.examples.serve_decode
  PYTHONPATH=src python -m repro_torch.examples.serve_decode \\
      --archs llama3.2-1b,mamba2-1.3b --device cpu

Each arch's reduced config decodes ``--gen`` greedy tokens after one
warm-up step from token 0, over a cache of 128 positions, through
``launch/steps.make_serve_step``: on the card every Mamba-2 layer runs
the ``ssd_update`` kernel each step.
"""
from __future__ import annotations

import argparse
import time

import torch

ARCHS = ("llama3.2-1b,h2o-danube-1.8b,mamba2-1.3b,mixtral-8x22b,"
         "deepseek-v2-236b")
MAX_LEN = 128


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_serve_decode(*, archs: str = ARCHS, batch: int = 4, gen: int = 24,
                     device=None, init_params=None) -> dict:
    """Per arch: {tokens (batch, gen) of the greedy decode, logits of
    each step (gen + 1, batch, vocab), tok_s}. ``init_params(cfg)``
    gives the params tree (e.g. the reference's ``PRNGKey(0)`` init
    through ``repro_torch.convert``); None draws it on the device from
    ``torch.Generator(device).manual_seed(0)``."""
    from repro_torch.configs import get_config
    from repro_torch.fl.runtime import resolve_device
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import transformer as tfm
    from repro_torch.models.forward import init_cache
    from repro_torch.models.module import tree_map

    device = resolve_device(device)
    out = {}
    for arch in archs.split(","):
        cfg = get_config(arch, reduced=True)
        params = (tfm.init_params(torch.Generator(device=device)
                                  .manual_seed(0), cfg)
                  if init_params is None else
                  tree_map(lambda t: torch.as_tensor(t).to(device),
                           init_params(cfg)))
        serve = make_serve_step(cfg)
        cache = init_cache(cfg, batch, MAX_LEN, device=device)
        tok = torch.zeros((batch, 1), dtype=torch.int32, device=device)
        # warmup + timed decode
        logits, cache = serve(params, cache, tok, 0)
        steps, toks = [logits[:, 0]], []
        _sync(device)
        t0 = time.perf_counter()
        for t in range(1, gen + 1):
            nxt = logits[:, 0].argmax(-1)[:, None].to(torch.int32)
            logits, cache = serve(params, cache, nxt, t)
            toks.append(nxt[:, 0])
            steps.append(logits[:, 0])
        _sync(device)
        dt = time.perf_counter() - t0
        out[arch] = {"tokens": torch.stack(toks, 1).cpu().numpy(),
                     "logits": torch.stack(steps).float().cpu().numpy(),
                     "tok_s": gen * batch / max(dt, 1e-9)}
    return out


def device_label(device: torch.device) -> str:
    """Where the reference prints "CPU": the device's name."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type.upper()


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default=ARCHS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device; default = the CUDA card (fails "
                         "without one), 'cpu' to run on the CPU")
    return ap.parse_args(argv)


def main(argv=None):
    from repro_torch.fl.runtime import resolve_device
    args = parse_args(argv)
    device = resolve_device(args.device)
    out = run_serve_decode(archs=args.archs, batch=args.batch, gen=args.gen,
                           device=device)
    for arch, r in out.items():
        print(f"{arch:20s} {r['tok_s']:7.1f} tok/s "
              f"(reduced config, {device_label(device)})")
    return out


if __name__ == "__main__":
    main()
