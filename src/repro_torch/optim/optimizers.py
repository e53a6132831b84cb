"""Local optimizer: momentum SGD as an (init, update) pair.

It works on any tensor; the round engine applies it to the cohort's
flat (C, M) parameter buffer, where it is the plain counterpart of the
fused ``kernels/local_step.py`` route.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable   # update(grads, state, params) -> (params, state)


def sgd(lr: float, momentum: float = 0.0,
        weight_decay: float = 0.0) -> Optimizer:
    """SGD with heavy-ball momentum (velocity starts at zero at every
    ``init``) and weight decay added to the gradient."""

    def init(params: torch.Tensor):
        return None if momentum == 0.0 else torch.zeros_like(params)

    def update(grads, state, params):
        if weight_decay:
            grads = grads + weight_decay * params
        if momentum == 0.0:
            return params - lr * grads, None
        vel = momentum * state + grads
        return params - lr * vel, vel

    return Optimizer(init, update)
