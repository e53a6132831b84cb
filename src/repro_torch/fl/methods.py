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
    host_fuse                               host_fusion methods only
                                            (fedma): completes the round
                                            from the stacked params

``fedavg`` is the all-defaults method; every other method overrides the
smallest hook set: ``fedprox`` only ``local_loss_term``, ``fed2`` only
``fuse`` (paired averaging, Eq. 19), ``fedma`` only ``fuse`` and
``host_fuse``, ``scaffold`` ``client_update`` and ``local_opt`` with
server control-variate state, ``fednova`` only ``fuse``, and
``fedavgm``/``fedadam`` only ``server_update``. Consumers enumerate
``available()`` and resolve instances with ``get(name)``: nothing
branches on a method's name.

Persistent state is flat like the params: a client's state row is a
flat (M,) value (scaffold's control variate), stacked (C, M) over the
cohort, and the server state a dict of such values.

The cohort's parameters are one flat (C, M_d) tensor per leaf dtype
(rows = clients, ``models/module.FlatLayout``: ONE (C, M) tensor for a
tree of one dtype, ``Segments`` for a tree that mixes them), and every
hook works on each dtype segment in its own dtype, as the reference's
``tree_map`` works on each leaf in its own. Gradients come back flat
from ``torch.func.vmap(torch.func.grad(...))``, one per segment. With
``ctx.use_local_kernel`` each step's momentum-SGD tail is one launch of
``kernels/local_step.py`` over ONE buffer of the whole tree (the
reference's ``ravel_pytree``): the cohort buffer itself for a tree of
one dtype, an fp32 copy of every leaf for a tree that mixes dtypes.
Under a bf16 ``compute_dtype`` the engine hands the local phase one
bf16 shadow of the whole tree with ``ctx.layout`` its one-buffer
layout, so the hooks see a tree of one dtype there.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import fusion as fusion_lib
from repro_torch.kernels.local_step import local_step
from repro_torch.models.module import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class MethodContext:
    """Per-run context handed to every hook (built by make_round_engine).

    population: the number of logical clients behind the run;
    cohort_size: the engine width (cohort slots). Hooks that scale by
    participation (scaffold's server control update) read both.
    local_steps: optimizer steps of each client's local phase.
    layout: the ``FlatLayout`` of one client's parameters.
    weights: per-cohort-slot sample weights (float32 tensor) or None;
    raw_weights keeps the host-side array (fedma's matched averaging
    reads it).
    group_axes: the task's GroupAxis tree (only when uses_groups).
    group_weights: per-slot (C, G) presence weights or None.
    use_kernel: fuse through the paired_fusion kernel.
    robust: the reducing robust rule (fl/robust.py) that replaces the
    fusion's weighted mean, or None.
    local_unroll: the validated ``FLConfig.local_unroll`` (eager torch
    has no scan to unroll: it changes neither result nor dispatch).
    use_local_kernel: run the optimizer tail through the local_step
    kernel (``fused_local_step`` methods only).
    ravel_buffer: that route's one fp32 (C, M) buffer of the whole tree
    when the tree mixes dtypes (``FlatLayout.ravel``), allocated once
    with the engine; None otherwise.
    grad_chunk: the clients each vmapped gradient call takes at a time
    (None: the whole cohort; ``run_federated(grad_chunk=...)``).
    shard: the ``core/fusion.RowShard`` of this rank's cohort rows on a
    mesh of ranks (fl/engine.py), or None (the whole cohort here). The
    local phase sees this rank's rows only (params, batches, client
    state); ``fuse`` combines the ranks' rows through it, and every
    later hook sees the whole cohort, as in one process."""
    task: Any
    cfg: Any
    population: int
    cohort_size: int
    local_steps: int
    opt: Any
    layout: Any
    weights: torch.Tensor | None
    raw_weights: Any
    group_axes: Any
    group_weights: torch.Tensor | None
    use_kernel: bool
    robust: Any = None
    local_unroll: int = 1
    use_local_kernel: bool = False
    ravel_buffer: Any = None
    grad_chunk: int | None = None
    shard: Any = None


class FedMethod:
    """Strategy base class; defaults compose to exactly FedAvg (Eq. 1)."""

    name: str = ""
    summary: str = ""          # one line for a method table
    uses_groups = False        # needs task.group_axes_fn (structural groups)
    host_fusion = False        # fuse completes on the host (fedma)
    client_stateful = False    # client_update reads per-client state
    cohort_tiling = True       # round may split into fuse-only cohort
    #                            tiles + one trailing server step; False
    #                            when server_update reads per-client state
    #                            (scaffold), which caps participants per
    #                            round at cohort_size

    @property
    def tier_fusion(self) -> bool:
        """Whether overlap-aware tiered fusion may drive this method: the
        cohort-tiling eligibility, minus per-client state and host
        fusion (the JAX package's ``FedMethod.tier_fusion``; the port
        has no tier engine yet, fl/compat.py)."""
        return (self.cohort_tiling and not self.host_fusion
                and not self.client_stateful)

    @property
    def async_eligible(self) -> bool:
        """Whether buffered-async federation may run this method:
        exactly the tier-fusion eligibility."""
        return self.tier_fusion

    @property
    def robust_fusion(self) -> bool:
        """Whether the robust rules of fl/robust.py may wrap this
        method's fuse: a rule replaces or precedes the cross-client
        reduction inside core/fusion.py, which every device-fused method
        runs; host fusion (fedma) has no coordinate reduction."""
        return not self.host_fusion

    @property
    def mixed_precision(self) -> bool:
        """Whether the engine may run this method's local phase in bf16
        with fp32 fusion: the cast happens at the round boundary, so the
        method must be client-stateless and fuse on the device. Exactly
        the tier-fusion eligibility."""
        return self.tier_fusion

    @property
    def uplink_codec(self) -> bool:
        """Whether an uplink codec (fl/codec.py) may compress this
        method's uplink: decode-then-fuse needs a device fuse and no
        client state that assumes the server saw the exact params.
        Exactly the tier-fusion eligibility."""
        return self.tier_fusion

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
        """ONE client's state ((M,) rows; () for stateless methods)."""
        return ()

    # -- local phase --------------------------------------------------------

    def local_loss_term(self, params, batch, global_params, ctx):
        """Extra local-loss term on one client's flat params (fedprox's
        proximal penalty). None = no term."""
        return None

    def client_update(self, stacked, batches, global_params, client_state,
                      server_state, ctx: MethodContext):
        """The cohort's local phase. stacked: the (C, M_d) flat params per
        segment; batches: dict of (C, steps, B, ...) tensors. Each step
        takes one gradient per client, vmapped over the cohort, then one
        optimizer step over each segment's whole buffer, in its dtype.
        Velocity starts at zero. Returns (new_stacked,
        new_client_state)."""
        layout = ctx.layout

        def loss(row, batch):
            base = ctx.task.loss_fn(layout.unflatten(row), batch)
            term = self.local_loss_term(row, batch, global_params, ctx)
            return base if term is None else base + term

        if ctx.use_local_kernel and self.fused_local_step:
            return self._kernel_client_update(stacked, batches, loss,
                                              client_state, ctx)
        grad_fn = _cohort_grad(loss, ctx)
        p, s = stacked, ctx.opt.init(stacked)
        for i in range(_n_steps(batches)):
            g = grad_fn(p, {k: b[:, i] for k, b in batches.items()})
            p, s = ctx.opt.update(g, s, p)
        return p, client_state

    def _kernel_client_update(self, stacked, batches, loss, client_state,
                              ctx: MethodContext):
        """The ``local_step`` route, as the reference's: ravel the cohort
        into ONE (C, M) buffer of the whole tree, step it with one
        launch a step and an fp32 (or the tree's one dtype) velocity,
        and unravel it back once at the end. For a tree of one dtype the
        raveled buffer is the cohort buffer itself; for one that mixes
        dtypes it is ``ctx.ravel_buffer`` in fp32 (``ravel_pytree``
        promotes), the loss sees each leaf cast to its dtype, and each
        bf16 leaf is rounded once, when the buffer is copied back."""
        layout = ctx.layout
        p = layout.ravel(stacked, out=ctx.ravel_buffer)
        lr, mu = float(ctx.cfg.lr), float(ctx.cfg.momentum)
        v = torch.zeros_like(p)
        grad_fn = _cohort_grad(
            lambda q, batch: loss(layout.unravel(q), batch), ctx)
        for i in range(_n_steps(batches)):
            g = grad_fn(p, {k: b[:, i] for k, b in batches.items()})
            local_step(p, v, g, lr=lr, mu=mu)   # in place on p, v
        return layout.unravel(p, out=stacked), client_state

    # -- aggregation --------------------------------------------------------

    def fuse(self, stacked, global_params, ctx: MethodContext):
        """Aggregation of the cohort's (C, M_d) params into (M_d,)."""
        return fusion_lib.fedavg(stacked, ctx.weights,
                                 use_kernel=ctx.use_kernel,
                                 robust=ctx.robust, shard=ctx.shard)

    def host_fuse(self, stacked, ctx: MethodContext):
        """Completion of the round from the stacked params (only when
        ``host_fusion``)."""
        raise NotImplementedError

    # -- server step --------------------------------------------------------

    def server_update(self, server_state, client_states, new_client_states,
                      global_params, fused, ctx: MethodContext):
        """(server_state, fused aggregate) -> (server_state, new_global)."""
        return server_state, fused


def _n_steps(batches: dict) -> int:
    return next(iter(batches.values())).shape[1]


def _cohort_grad(loss, ctx: MethodContext):
    """``(rows, batch) -> grads``: ``loss``'s gradient per client,
    vmapped over the cohort, ``ctx.grad_chunk`` clients at a time."""
    return torch.func.vmap(torch.func.grad(loss), chunk_size=ctx.grad_chunk)


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
    summary = "coordinate-based (sample-weighted) mean, Eq. 1/18"


@register
class FedProx(FedMethod):
    """FedAvg + proximal local loss (Li et al., MLSys'20)."""
    name = "fedprox"
    summary = "fedavg + proximal local-loss penalty toward the global"

    def local_loss_term(self, params, batch, global_params, ctx):
        return fusion_lib.fedprox_penalty(params, global_params,
                                          ctx.cfg.prox_mu)


@register
class Fed2(FedMethod):
    """Feature paired averaging (Eq. 19) over the group-axis tree."""
    name = "fed2"
    summary = "feature paired averaging over structure groups, Eq. 19"
    uses_groups = True

    def fuse(self, stacked, global_params, ctx):
        return fusion_lib.paired_average(stacked, ctx.layout,
                                         ctx.group_axes,
                                         weights=ctx.weights,
                                         group_weights=ctx.group_weights,
                                         use_kernel=ctx.use_kernel,
                                         robust=ctx.robust, shard=ctx.shard)


@register
class FedMA(FedMethod):
    """Matched averaging (Wang et al., ICLR'20 style, core/matching.py):
    the device round ends at the stacked client params; Hungarian
    matching fuses them between rounds."""
    name = "fedma"
    summary = "host-side Hungarian matched averaging (core/matching.py)"
    host_fusion = True

    def check(self, ctx):
        if ctx.task.matched_average_fn is None:
            raise ValueError("fedma requires task.matched_average_fn "
                             "(defined for non-grouped CNNs)")

    def fuse(self, stacked, global_params, ctx):
        """The stacked params, fused by ``host_fuse``; on a mesh of
        ranks the whole cohort's, gathered in slot order, so every rank
        matches the same rows."""
        if ctx.shard is None:
            return stacked
        return tree_map(ctx.shard.gather, stacked)

    def host_fuse(self, stacked, ctx):
        """(C, M) stacked params -> the matched average, flat (M,)."""
        fused = ctx.task.matched_average_fn(ctx.layout.unflatten(stacked),
                                            ctx.raw_weights)
        return ctx.layout.flatten(fused)


# ---------------------------------------------------------------------------
# Beyond-paper methods
# ---------------------------------------------------------------------------


@register
class Scaffold(FedMethod):
    """SCAFFOLD (Karimireddy et al., ICML'20): per-client control variates
    c_i and a server variate c correct client drift: every local gradient
    becomes g - c_i + c. c_i rides the cohort's (C, M) state rows through
    the local phase, c lives in the server state. The local phase runs
    momentum-free SGD: the option-II control update reads the mean local
    gradient off (x - y_i)/(K*lr), which heavy-ball momentum would
    inflate.

    Participation: c_i lives in the population state (a client that
    sits a round out keeps its variate); the server update scales by
    |S|/N (cohort/population). On a mesh of ranks the engine hands
    ``client_update`` this rank's c_i rows and ``server_update`` the
    whole cohort's, gathered (fl/engine.py), so every rank takes the
    one-process server step. ``cohort_tiling = False``: the server
    update reads the participating clients' state deltas, so one round
    must fit one cohort."""
    name = "scaffold"
    summary = "client/server control variates correct local drift"
    client_stateful = True
    cohort_tiling = False

    def local_opt(self, cfg):
        from repro_torch.optim.optimizers import sgd
        return sgd(cfg.lr, 0.0)

    def init_server_state(self, params, ctx):
        return {"c": tree_map(torch.zeros_like, params)}

    def init_client_state(self, params, ctx):
        return tree_map(torch.zeros_like, params)

    def client_update(self, stacked, batches, global_params, client_state,
                      server_state, ctx):
        layout, opt = ctx.layout, ctx.opt
        ci, c = client_state, server_state["c"]
        grad_fn = _cohort_grad(
            lambda row, batch: ctx.task.loss_fn(layout.unflatten(row),
                                                batch), ctx)
        p, s = stacked, opt.init(stacked)
        for i in range(_n_steps(batches)):
            g = grad_fn(p, {k: b[:, i] for k, b in batches.items()})
            p, s = opt.update(tree_map(lambda gl, cil, cl: gl - cil + cl,
                                       g, ci, c), s, p)
        # option-II control update: c_i+ = c_i - c + (x - y_i) / (K * lr)
        k_lr = ctx.local_steps * ctx.cfg.lr
        return p, tree_map(lambda cil, cl, x, y: cil - cl + (x - y) / k_lr,
                           ci, c, global_params, p)

    def server_update(self, server_state, client_states, new_client_states,
                      global_params, fused, ctx):
        # c <- c + (|S|/N) mean_{i in S}(c_i+ - c_i); |S| = cohort slots,
        # N = population. Full participation (|S| == N) leaves the factor
        # out, as the reference does.
        scale = ctx.cohort_size / ctx.population

        def upd(cl, old, new):
            step = (new - old).mean(0)
            return cl + step if scale == 1.0 else cl + scale * step
        return {"c": tree_map(upd, server_state["c"], client_states,
                              new_client_states)}, fused


@register
class FedNova(FedMethod):
    """FedNova (Wang et al., NeurIPS'20): aggregate NORMALIZED client
    deltas d_i = (x - y_i)/tau_i and apply their weighted mean rescaled by
    the effective step count tau_eff. Every client runs the same
    tau = local_steps, under which fednova equals fedavg."""
    name = "fednova"
    summary = "normalized-delta aggregation (tau-rescaled fedavg)"

    def fuse(self, stacked, global_params, ctx):
        tau = float(ctx.local_steps)
        deltas = tree_map(lambda y, x: (x[None] - y) / tau, stacked,
                          global_params)
        d = fusion_lib.fedavg(deltas, ctx.weights,
                              use_kernel=ctx.use_kernel,
                              robust=ctx.robust, shard=ctx.shard)
        tau_eff = tau            # all clients run local_steps steps
        return tree_map(lambda x, dl: x - tau_eff * dl, global_params, d)


@register
class FedAvgM(FedMethod):
    """FedAvg with server momentum (Hsu et al. '19): the server treats the
    round delta x - fused as a pseudo-gradient and applies heavy-ball
    momentum (cfg.server_momentum, cfg.server_lr) over rounds."""
    name = "fedavgm"
    summary = "server heavy-ball momentum on round deltas"

    def init_server_state(self, params, ctx):
        return {"v": tree_map(torch.zeros_like, params)}

    def server_update(self, server_state, client_states, new_client_states,
                      global_params, fused, ctx):
        beta, lr = ctx.cfg.server_momentum, ctx.cfg.server_lr
        v = tree_map(lambda vl, x, f: beta * vl + (x - f),
                     server_state["v"], global_params, fused)
        return {"v": v}, tree_map(lambda x, vl: x - lr * vl, global_params,
                                  v)


@register
class FedAdam(FedMethod):
    """FedAdam (Reddi et al., ICLR'21 FedOpt): Adam on the server over
    round pseudo-gradients; m/v state threads across rounds. Step size is
    cfg.server_lr with the FedOpt adaptivity floor eps=1e-3."""
    name = "fedadam"
    summary = "server Adam over round pseudo-gradients (FedOpt)"
    b1, b2, eps = 0.9, 0.99, 1e-3

    @property
    def mixed_precision(self) -> bool:
        """False despite tier fusion: the server step divides the round
        pseudo-gradient by sqrt(v) + eps, so on coordinates whose v is
        near zero a bf16 perturbation flips the sign of an O(server_lr)
        step. Exact local phases only, as in the JAX package."""
        return False

    @property
    def uplink_codec(self) -> bool:
        """False for the same reason: the adaptive normalization turns a
        lossy uplink's reconstruction error into sign-flipped server
        steps. Exact uplinks only."""
        return False

    def init_server_state(self, params, ctx):
        z = tree_map(torch.zeros_like, params)
        return {"m": z, "v": z,
                "t": torch.zeros((), dtype=torch.float32,
                                 device=tree_leaves(params)[0].device)}

    def server_update(self, server_state, client_states, new_client_states,
                      global_params, fused, ctx):
        b1, b2, lr = self.b1, self.b2, ctx.cfg.server_lr
        t = server_state["t"] + 1.0
        d = tree_map(lambda x, f: x - f, global_params, fused)
        m = tree_map(lambda ml, dl: b1 * ml + (1 - b1) * dl,
                     server_state["m"], d)
        v = tree_map(lambda vl, dl: b2 * vl + (1 - b2) * torch.square(dl),
                     server_state["v"], d)

        def upd(x, ml, vl):
            mh = ml / (1 - b1 ** t)
            vh = vl / (1 - b2 ** t)
            return x - lr * mh / (torch.sqrt(vh) + self.eps)
        return {"m": m, "v": v, "t": t}, tree_map(upd, global_params, m, v)
