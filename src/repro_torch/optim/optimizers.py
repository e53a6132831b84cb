"""Optimizers as (init, update) pairs: the port of
``repro.optim.optimizers``.

``sgd`` works on any tensor or tree of tensors, in place; the round
engine applies it to the cohort's flat (C, M_d) parameter buffers, where
it is the plain counterpart of the fused ``kernels/local_step.py``
route. ``adamw``,
``cosine_schedule`` and ``clip_by_global_norm`` work on parameter trees
(the LM's training step, ``launch/steps.py``), with the reference's
arithmetic: fp32 bias correction at ``t = step + 1``, and for bf16
params with fp32 state the update computed in fp32 and cast back.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.models.module import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable
    # sgd: update(grads, state, params) -> (params, state);
    # adamw: update(grads, state, params, step) -> (params, state)
    update: Callable


def sgd(lr: float, momentum: float = 0.0,
        weight_decay: float = 0.0) -> Optimizer:
    """SGD with heavy-ball momentum (velocity starts at zero, in each
    leaf's dtype, at every ``init``) and weight decay added to the
    gradient, leaf by leaf over a tensor or a tree (the round engine's
    flat value: one tensor per dtype segment, each stepping in its own
    dtype). ``update`` writes the new params and velocity over the old
    ones and returns them: the same operations, each rounded once, as
    ``p - lr * (mu * v + g)``, without the two extra copies of the
    params (a full-depth bf16 Mamba-2 cohort is 11 GB)."""

    def init(params):
        return None if momentum == 0.0 else tree_map(torch.zeros_like,
                                                     params)

    def step(p, g, v=None):
        if weight_decay:
            g = g + weight_decay * p
        if v is not None:
            g = v.mul_(momentum).add_(g)
        p.sub_(lr * g)
        return p

    def update(grads, state, params):
        if momentum == 0.0:
            return tree_map(step, params, grads), None
        return tree_map(step, params, grads, state), state

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0, state_dtype=None) -> Optimizer:
    """AdamW over a params tree. ``lr`` is a float or ``lr(step)``;
    ``state_dtype=torch.float32`` keeps fp32 m and v for bf16 params (the
    production configuration), else each leaf's own dtype.
    ``update(grads, state, params, step)`` -> (new params, new state),
    step an int counted from 0."""
    lr_fn = lr if callable(lr) else (lambda step: lr)

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=state_dtype or p.dtype,
                               device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(grads, state, params, step):
        dev = tree_leaves(params)[0].device
        t = torch.tensor(step, dtype=torch.float32, device=dev) + 1.0
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t          # fp32 bias corrections
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(m_.dtype),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2)
                     * torch.square(g.to(v_.dtype)), state["v"], grads)
        lr_t = lr_fn(step)

        def upd(p, m_, v_):
            mh = m_ / c1
            vh = v_ / c2
            step_ = lr_t * (mh / (torch.sqrt(vh) + eps)
                            + weight_decay * p.to(m_.dtype))
            return (p.to(m_.dtype) - step_).to(p.dtype)

        return tree_map(upd, params, m, v), {"m": m, "v": v}

    return Optimizer(init, update)


def cosine_schedule(base_lr: float, total_steps: int,
                    warmup_steps: int = 0, min_frac: float = 0.1):
    """``lr(step)``: linear warm-up, then cosine decay to ``min_frac`` of
    ``base_lr``; an fp32 0-dim tensor, as the reference computes it."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = torch.clamp(step / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi
                                                               * prog))
        return base_lr * warm * cos
    return lr


def clip_by_global_norm(grads, max_norm: float):
    """Scale a grads tree by min(1, max_norm / ||grads||), the norm over
    every leaf in fp32; each leaf scaled in fp32 and cast back to its
    dtype."""
    sq = sum(torch.sum(torch.square(g.to(torch.float32)))
             for g in tree_leaves(grads))
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads)
