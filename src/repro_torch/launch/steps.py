"""Serve step shared by the serving launcher and its tests: the port of
``repro.launch.steps.make_serve_step`` (PyTorch runs eagerly, so there
is nothing to jit)."""
from __future__ import annotations

from repro_torch.models.forward import decode_step


def make_serve_step(cfg):
    def serve_step(params, cache, tokens, pos):
        return decode_step(params, cfg, cache, tokens, pos)
    return serve_step
