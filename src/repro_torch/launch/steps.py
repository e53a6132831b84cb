"""Train, eval, prefill and serve steps shared by the launchers and their
tests: the port of ``repro.launch.steps`` (PyTorch runs eagerly, so
there is nothing to jit).

The train step takes its gradients with plain autograd, so the model's
remat (``ModelConfig.remat_blocks`` and the SSD chunks) applies. The
eval and prefill steps run under ``torch.no_grad`` and take the Fed2
unembedding's ``grouped_matmul`` kernel route; the train step never
does (the kernel has no backward).

``make_prefill_loss_step`` and ``make_serve_step`` take ``mesh=``, this
rank's ``launch/mesh.RankMesh``: the step is then the rank's program of
the sharded prefill loss or decode (``models/parallel.py``; dense and
ssm families), called with the rank's shares of the parameters and the
cache (``launch/sharding.cut``, ``forward.init_cache(mesh=)``) and its
batch rows (``launch/sharding.batch_rows``). The train step has no
sharded program yet: ``make_train_step`` refuses a mesh of more than
one rank.
"""
from __future__ import annotations

import torch

from repro_torch.models.forward import decode_step, lm_loss
from repro_torch.models.parallel import check_sharded, is_split
from repro_torch.models.module import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim.optimizers import adamw


def value_and_grad(params, cfg, batch):
    """(lm_loss, its gradient tree) by plain autograd; the loss
    detached."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss = lm_loss(tree_unflatten(params, leaves), cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


def make_train_step(cfg, *, lr: float = 3e-4, microbatches: int = 1,
                    mesh=None):
    """``microbatches > 1`` splits the global batch (every entry of it,
    ``"embeds"`` too, along the batch axis) and accumulates the grads in
    fp32, then scales loss and grads by ``1/microbatches``: saved
    activations are bounded by one microbatch.

    The grads are cast to bf16 before the optimizer, as the reference
    does by default (its ``grad_sync_dtype``, which halves a gradient
    all-reduce that one card does not have): the update stays the
    reference's only with that rounding.

    Returns (train_step, opt): ``train_step(params, opt_state, step,
    batch) -> (params, opt_state, loss)``, step an int from 0. A mesh
    of more than one rank is refused: the sharded train step
    (tensor-parallel backward, ZeRO-1, the bf16 gradient sync) is not
    ported."""
    if is_split(mesh):
        raise NotImplementedError(
            f"make_train_step on a mesh of {mesh.size} ranks: the port's "
            f"sharded programs are prefill and decode only (no "
            f"tensor-parallel backward, ZeRO-1 or gradient sync)")
    opt = adamw(lr, weight_decay=0.1, state_dtype=torch.float32)

    def train_step(params, opt_state, step, batch):
        if microbatches == 1:
            loss, grads = value_and_grad(params, cfg, batch)
        else:
            mb = {k: v.reshape((microbatches, -1) + tuple(v.shape[1:]))
                  for k, v in batch.items()}
            dev = tree_leaves(params)[0].device
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device), params)
            for i in range(microbatches):
                l_, g = value_and_grad(params, cfg,
                                       {k: v[i] for k, v in mb.items()})
                loss = loss + l_
                grads = tree_map(lambda a, gg: a + gg.to(a.dtype), grads, g)
            inv = 1.0 / microbatches
            loss = loss * inv
            grads = tree_map(lambda g: g * inv, grads)
        grads = tree_map(lambda g: g.to(torch.bfloat16), grads)
        params, opt_state = opt.update(grads, opt_state, params, step)
        return params, opt_state, loss

    return train_step, opt


def make_eval_step(cfg):
    @torch.no_grad()
    def eval_step(params, batch):
        return lm_loss(params, cfg, batch, use_kernel=True)
    return eval_step


def make_serve_step(cfg, *, use_kernel: bool = True, mesh=None):
    """``use_kernel=False`` takes the plain routes (``decode_step``'s):
    the dry-run's pass over meta tensors, which no kernel accepts.
    ``mesh``: the rank's program (module docstring); the logits of its
    rows come back whole."""
    check_sharded(cfg, mesh, "make_serve_step")

    def serve_step(params, cache, tokens, pos):
        return decode_step(params, cfg, cache, tokens, pos,
                           use_kernel=use_kernel, mesh=mesh)
    return serve_step


def make_prefill_loss_step(cfg, *, use_kernel: bool = True, mesh=None):
    """Forward-only loss (the reference's prefill_32k target: one
    full-context forward pass, no optimizer); ``use_kernel=False`` takes
    the unembedding's einsum, as ``make_serve_step``'s. ``mesh``: the
    rank's program (module docstring); every rank returns the whole
    batch's loss."""
    check_sharded(cfg, mesh, "make_prefill_loss_step")

    @torch.no_grad()
    def prefill_step(params, batch):
        return lm_loss(params, cfg, batch, use_kernel=use_kernel, mesh=mesh)
    return prefill_step
