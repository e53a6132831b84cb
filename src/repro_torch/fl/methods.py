"""Federated method strategy API.

A federated method is a ``FedMethod`` subclass registered by name. The
round engine (fl/engine.py) is method-agnostic: it composes the
method's hooks into one round and threads the method's persistent state
(a server-side tree plus per-client rows) across rounds.

Hook order inside a round:

    init_server_state / init_client_state   once, before round 0
    client_update                           local phase of the whole
                                            cohort: ``local_steps``
                                            optimizer steps, each one
                                            gradient vmapped over the
                                            cohort slots
    fuse                                    aggregation over the cohort
    server_update                           server-state step -> global

``fedavg`` is the all-defaults method; ``fedprox`` overrides only
``local_loss_term`` and ``fed2`` only ``fuse`` (paired averaging,
Eq. 19). Consumers enumerate ``available()`` and resolve instances with
``get(name)``: nothing branches on a method's name.

The cohort's parameters are one flat (C, M) tensor (rows = clients,
``models/module.FlatLayout``); gradients come back flat from
``torch.func.vmap(torch.func.grad(...))``, and with
``ctx.use_local_kernel`` each step's momentum-SGD tail is one launch of
``kernels/local_step.py`` over the whole buffer.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import fusion as fusion_lib
from repro_torch.kernels.local_step import local_step


@dataclasses.dataclass(frozen=True)
class MethodContext:
    """Per-run context handed to every hook (built by make_round_engine).

    layout: the ``FlatLayout`` of one client's parameters.
    weights: per-cohort-slot sample weights (float32 tensor) or None.
    group_axes: the task's GroupAxis tree (only when uses_groups).
    group_weights: per-slot (C, G) presence weights or None.
    use_kernel: fuse through the paired_fusion kernel.
    use_local_kernel: run the optimizer tail through the local_step
    kernel (``fused_local_step`` methods only)."""
    task: Any
    cfg: Any
    opt: Any
    layout: Any
    weights: torch.Tensor | None
    group_axes: Any
    group_weights: torch.Tensor | None
    use_kernel: bool
    use_local_kernel: bool = False


class FedMethod:
    """Strategy base class; defaults compose to exactly FedAvg (Eq. 1)."""

    name: str = ""
    uses_groups = False        # needs task.group_axes_fn (structural groups)
    cohort_tiling = True       # round may split into fuse-only cohort
    #                            tiles + one trailing server step

    @property
    def fused_local_step(self) -> bool:
        """Whether the fused ``local_step`` kernel may drive this
        method's optimizer tail: the kernel IS momentum-SGD on the flat
        params, so the method must run the default client_update with
        the default local optimizer."""
        return (type(self).client_update is FedMethod.client_update
                and type(self).local_opt is FedMethod.local_opt)

    def local_opt(self, cfg):
        """The optimizer of the local phase: the config's SGD+momentum."""
        from repro_torch.optim.optimizers import sgd
        return sgd(cfg.lr, cfg.momentum)

    def check(self, ctx: MethodContext) -> None:
        """Raise ValueError when the task lacks what the method needs."""
        if self.uses_groups and ctx.task.group_axes_fn is None:
            raise ValueError(f"{self.name} requires task.group_axes_fn")

    # -- persistent state ---------------------------------------------------

    def init_server_state(self, params, ctx: MethodContext):
        return ()

    def init_client_state(self, params, ctx: MethodContext):
        """ONE client's state tree (() for stateless methods)."""
        return ()

    # -- local phase --------------------------------------------------------

    def local_loss_term(self, params, batch, global_params, ctx):
        """Extra local-loss term on one client's flat params (fedprox's
        proximal penalty). None = no term."""
        return None

    def client_update(self, stacked, batches, global_params, client_state,
                      server_state, ctx: MethodContext):
        """The cohort's local phase. stacked: (C, M) flat params; batches:
        dict of (C, steps, B, ...) tensors. Each step takes one gradient
        per client, vmapped over the cohort, then one optimizer step over
        the whole buffer. Velocity starts at zero. Returns
        (new_stacked, new_client_state)."""
        layout = ctx.layout

        def loss(row, batch):
            base = ctx.task.loss_fn(layout.unflatten(row), batch)
            term = self.local_loss_term(row, batch, global_params, ctx)
            return base if term is None else base + term

        grad_fn = torch.func.vmap(torch.func.grad(loss))
        n_steps = next(iter(batches.values())).shape[1]
        kernel = ctx.use_local_kernel and self.fused_local_step
        p = stacked
        if kernel:
            lr, mu = float(ctx.cfg.lr), float(ctx.cfg.momentum)
            v = torch.zeros_like(p)
        else:
            s = ctx.opt.init(p)
        for i in range(n_steps):
            g = grad_fn(p, {k: b[:, i] for k, b in batches.items()})
            if kernel:
                local_step(p, v, g, lr=lr, mu=mu)   # in place on p, v
            else:
                p, s = ctx.opt.update(g, s, p)
        return p, client_state

    # -- aggregation --------------------------------------------------------

    def fuse(self, stacked, global_params, ctx: MethodContext):
        """Aggregation of the cohort's (C, M) params into (M,)."""
        return fusion_lib.fedavg(stacked, ctx.weights,
                                 use_kernel=ctx.use_kernel)

    # -- server step --------------------------------------------------------

    def server_update(self, server_state, client_states, new_client_states,
                      global_params, fused, ctx: MethodContext):
        """(server_state, fused aggregate) -> (server_state, new_global)."""
        return server_state, fused


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, type[FedMethod]] = {}


def register(cls: type[FedMethod]) -> type[FedMethod]:
    """Class decorator: register ``cls`` under ``cls.name``."""
    if not cls.name:
        raise ValueError(f"{cls.__name__} must set a non-empty .name")
    _REGISTRY[cls.name] = cls
    return cls


def available() -> tuple[str, ...]:
    """All registered method names, sorted."""
    return tuple(sorted(_REGISTRY))


def get(name: str) -> FedMethod:
    """A fresh method instance by registry name."""
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise ValueError(
            f"unknown federated method {name!r}; available: "
            f"{', '.join(available())}") from None


@register
class FedAvg(FedMethod):
    """Coordinate-based averaging (Eq. 1/18): the all-defaults method."""
    name = "fedavg"


@register
class FedProx(FedMethod):
    """FedAvg + proximal local loss (Li et al., MLSys'20)."""
    name = "fedprox"

    def local_loss_term(self, params, batch, global_params, ctx):
        return fusion_lib.fedprox_penalty(params, global_params,
                                          ctx.cfg.prox_mu)


@register
class Fed2(FedMethod):
    """Feature paired averaging (Eq. 19) over the group-axis tree."""
    name = "fed2"
    uses_groups = True

    def fuse(self, stacked, global_params, ctx):
        return fusion_lib.paired_average(stacked, ctx.layout,
                                         ctx.group_axes,
                                         weights=ctx.weights,
                                         group_weights=ctx.group_weights,
                                         use_kernel=ctx.use_kernel)
