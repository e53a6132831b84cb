"""Federated round engine on one device.

One round over a fixed-width COHORT of client slots (width =
``cfg.cohort_size``; the engine never sees the logical population):

    stacked <- broadcast(global)               # round start
    stacked, cstate <- method.client_update(stacked, batches, cstate)
    fused   <- method.fuse(stacked)            # the only cross-cohort op
    sstate, global <- method.server_update(sstate, fused)
    global  <- method.host_fuse(stacked)       # host_fusion methods only

The cohort lives in ONE flat (C, M) buffer (rows = clients, per-leaf
views through ``FlatLayout``) of the params' dtype, allocated once and
reused every round (a tree that mixes leaf dtypes is refused: one
buffer would round its leaves to one dtype):
broadcast is one copy into it, the local phase takes a vmapped gradient
over its rows, the ``local_step`` kernel route updates it in place, and
the fusion reads it in one ``paired_fusion`` launch when all leaves share
the sample weights.

The method comes from the fl/methods.py registry; the engine never
branches on its name. Because cohorts are sampled each round, the
per-slot fusion weights ``w`` (and fed2's presence rows ``gw``) are round
arguments: fusion renormalizes them over the participants it sees.

The feature axes of the sync round slot in at its boundaries, in the
JAX package's order (``local_and_fuse``, its fl/engine.py):

    stacked <- broadcast(global)
    work    <- stacked cast to the compute dtype   # bf16: the shadow
    work    <- method.client_update(work, batches cast down, ...)
    work    <- attack.poison_update(work, global)  # malicious rows, in
    #                                                the compute dtype
    stacked <- work cast back to fp32
    stacked <- codec.roundtrip(stacked, global)   # decode-then-fuse
    stacked <- robust.pre(stacked, global)        # norm_clip
    fused   <- method.fuse(stacked)               # robust.reduce inside

With ``compute_dtype="bfloat16"`` the local phase runs in a bf16 (C, M)
shadow of the cohort buffer, allocated once: broadcast writes the
global into it (the cast down), the ``local_step`` kernel route updates
it in place with a bf16 velocity, the batches' float leaves are cast to
bf16 (integer leaves are not), and the trained rows are copied back
into the fp32 buffer, which the fusion reads.

For rounds whose participant set exceeds one cohort (cohort tiling),
``run_tile`` executes local phase + fuse for one tile, and
``finish_round`` applies the server step once to the tiles' combined
fusion result (``host_fuse`` once to the tiles' stacked params, for
host-fusion methods). The capacity tiers (fl/capacity.py) run one
engine per tier through ``run_tile``; the buffered-async driver
(fl/async_engine.py) splits the tile at the fusion boundary:
``local_phase`` for a dispatch group, ``method.fuse`` and
``server_update`` under ``round_ctx`` for a fusion event.

Client state comes in as host (numpy) rows or as device tensors and
goes out on the device; the runtime decides where it lives between
rounds (fl/runtime.py).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import fusion as fusion_lib
from repro_torch.fl import attacks as attacks_lib
from repro_torch.fl import codec as codec_lib
from repro_torch.fl import compat as compat_lib
from repro_torch.fl import methods as methods_lib
from repro_torch.fl import robust as robust_lib
from repro_torch.fl.methods import FedMethod, MethodContext
from repro_torch.models.module import FlatLayout, tree_leaves, tree_map


def resolve_compute_dtype(compute_dtype, method: FedMethod):
    """The engine's mixed-precision decision: ``"float32"``/None keeps
    the fp32 local phase (None); ``"bfloat16"`` returns torch.bfloat16
    for the LOCAL phase, with fp32 fusion. Refused for methods without
    ``FedMethod.mixed_precision``."""
    if compute_dtype in (None, "", "float32"):
        return None
    if compute_dtype != "bfloat16":
        raise ValueError(
            f"unknown compute_dtype {compute_dtype!r}; choose 'float32' "
            "or 'bfloat16'")
    compat_lib.check_bf16_support(method)
    return torch.bfloat16


def resolve_local_unroll(cfg, local_steps: int) -> int:
    """``cfg.local_unroll`` clamped to the step count, as the JAX
    package resolves it. There it unrolls the local phase's
    ``lax.scan`` (batched dispatch, same step arithmetic); eager torch
    has no scan, so in the port the knob is validated and recorded and
    changes neither the result nor the dispatch."""
    return max(1, min(int(getattr(cfg, "local_unroll", 1)), local_steps))


@dataclasses.dataclass
class RoundEngine:
    """One federated round over cohort slots, on ``device``.

        state, new_global = engine.run_round(state, global_params,
                                             batches, weights=w,
                                             group_weights=gw)

    ``global_params`` is the flat (M,) global vector of ``layout``;
    ``batches`` a dict of (C, steps, B, ...) tensors on the device;
    ``state`` = {"server": tree, "clients": stacked (C, ...) rows}.
    ``weights``/``group_weights`` are per round: the sampled cohort's
    sample weights (and fed2 presence rows) in slot order.
    ``malicious`` is the tile's (host attacker row, round key) pair when
    a model-poisoning attack is configured, else None."""
    cohort_size: int
    method: FedMethod
    layout: FlatLayout
    device: torch.device
    ctx: MethodContext
    cohort: torch.Tensor          # the reusable (C, M) buffer
    attack: Any = None            # model-poisoning Attack or None
    robust: Any = None            # reducing RobustRule or None
    pre_rule: Any = None          # pre-fuse RobustRule (norm_clip) or None
    codec: Any = None             # UplinkCodec or None
    compute_dtype: Any = None     # torch.bfloat16 or None (fp32)
    shadow: torch.Tensor | None = None  # bf16 (C, M) local-phase buffer

    def _w32(self, w):
        return (None if w is None else
                torch.as_tensor(np.asarray(w), dtype=torch.float32,
                                device=self.device))

    def _to_device(self, tree):
        return tree_map(lambda a: torch.as_tensor(a, device=self.device),
                        tree)

    def init_server_state(self, global_params) -> Any:
        return self.method.init_server_state(global_params, self.ctx)

    def init_client_row(self, global_params) -> Any:
        """ONE client's round-0 state as host (numpy) arrays."""
        return tree_map(lambda t: t.cpu().numpy(),
                        self.method.init_client_state(global_params,
                                                      self.ctx))

    def round_ctx(self, weights=None, group_weights=None) -> MethodContext:
        """The engine's context with one round's (or fusion event's)
        sample weights and presence rows, as float32 device tensors."""
        return dataclasses.replace(self.ctx, weights=self._w32(weights),
                                   group_weights=self._w32(group_weights))

    def local_phase(self, clients_state, server_state, global_params,
                    batches, ctx, malicious=None) -> tuple:
        """The uplink half of a cohort tile: broadcast -> (cast down) ->
        local phase -> (poison) -> (cast back) -> (codec) -> (robust
        pre). ``clients_state`` must be on the device already. Returns
        (stacked, new client states): ``stacked`` is the engine's (C, M)
        cohort buffer (or a tensor made from it), which the next tile
        overwrites."""
        stacked = fusion_lib.broadcast_global(global_params, self.cohort)
        work, gp_local = stacked, global_params
        if self.compute_dtype is not None:
            work = fusion_lib.broadcast_global(global_params, self.shadow)
            batches = {k: v.to(self.compute_dtype)
                       if v.is_floating_point() else v
                       for k, v in batches.items()}
            gp_local = global_params.to(self.compute_dtype)
        work, new_clients = self.method.client_update(
            work, batches, gp_local, clients_state, server_state, ctx)
        if self.attack is not None and malicious is not None:
            row, key = malicious
            work = self.attack.poison_update(work, global_params, row, key,
                                             self.layout)
        if self.compute_dtype is not None:
            work = stacked.copy_(work)          # back to the fp32 buffer
        stacked = work
        if self.codec is not None:
            stacked = self.codec.roundtrip(stacked, global_params,
                                           self.layout)
        if self.pre_rule is not None:
            stacked = self.pre_rule.pre(stacked, global_params)
        return stacked, new_clients

    def _local_and_fuse(self, clients_state, server_state, global_params,
                        batches, weights, group_weights, malicious=None):
        """The shared cohort-tile body: ``local_phase``, then the fuse.
        Returns (clients_state on the device, new client states, fuse
        output, the round's context)."""
        ctx = self.round_ctx(weights, group_weights)
        clients_state = self._to_device(clients_state)
        stacked, new_clients = self.local_phase(
            clients_state, server_state, global_params, batches, ctx,
            malicious)
        fused = self.method.fuse(stacked, global_params, ctx)
        return clients_state, new_clients, fused, ctx

    def run_round(self, state, global_params, batches, weights=None,
                  group_weights=None, malicious=None) -> tuple:
        """One whole round. For host-fusion methods the round ends in
        ``host_fuse`` with the participants' raw ``weights``."""
        old_clients, new_clients, fused, ctx = self._local_and_fuse(
            state["clients"], state["server"], global_params, batches,
            weights, group_weights, malicious)
        new_server, out = self.method.server_update(
            state["server"], old_clients, new_clients, global_params,
            fused, ctx)
        if self.method.host_fusion:
            out = self.host_fuse(out, weights)
        return {"server": new_server, "clients": new_clients}, out

    def run_tile(self, client_states, server_state, global_params,
                 batches, weights=None, group_weights=None,
                 malicious=None) -> tuple:
        """One cohort tile of a tiled round: local phase + fuse only.
        Returns (new_client_states, fuse output)."""
        _, new_clients, fused, _ = self._local_and_fuse(
            client_states, server_state, global_params, batches, weights,
            group_weights, malicious)
        return new_clients, fused

    def finish_round(self, server_state, global_params, fused) -> tuple:
        """The server step of a tiled round, applied once to the combined
        fusion result (``cohort_tiling`` methods only)."""
        return self.method.server_update(server_state, (), (),
                                         global_params, fused, self.ctx)

    def host_fuse(self, stacked, weights=None):
        """Host-side fusion completion (host_fusion methods) of the
        (n, M) stacked params with the participants' raw weights."""
        ctx = (self.ctx if weights is None
               else dataclasses.replace(self.ctx, raw_weights=weights))
        return self.method.host_fuse(stacked, ctx)


def params_dtype(params_like) -> torch.dtype:
    """The one leaf dtype of a params tree, which the engine's flat
    buffers take. A tree that mixes dtypes (a bf16 Mamba-2 keeps
    ``a_log``, ``dt_bias`` and ``d_skip`` in fp32) is refused: the flat
    (C, M) cohort has one dtype, and the JAX package keeps every leaf in
    its own."""
    dtypes = {t.dtype for t in tree_leaves(params_like) if t is not None}
    if len(dtypes) != 1:
        names = ", ".join(sorted(str(d).replace("torch.", "")
                                 for d in dtypes))
        raise ValueError(
            f"the params tree has leaves of {len(dtypes)} dtypes "
            f"({names}); the round engine keeps a cohort in one flat "
            "buffer of one dtype and would round the others to it. Use a "
            "config of one dtype, e.g. "
            "mamba2_1_3b.full(dtype=torch.float32)")
    return dtypes.pop()


def make_round_engine(task, cfg, params_like, *, device,
                      use_kernel: bool | None = None,
                      use_local_kernel: bool = False,
                      method: FedMethod | None = None) -> RoundEngine:
    """Build the engine for (task, cfg, method) at width cfg.cohort_size.

    params_like: a params tree (its structure and leaf shapes define the
    flat layout and the group-axis tree).
    use_kernel: fuse through the ``paired_fusion`` kernel (None = yes,
    on every device: on CPU tensors its wrapper computes the plain
    version).
    use_local_kernel: run the local optimizer tail through the
    ``local_step`` kernel; a no-op for methods without
    ``fused_local_step``.

    cfg's feature knobs (each off by default) are resolved here, so
    every construction path hits the same refusals (``compat.validate``):
    ``attack`` (model-poisoning attacks only enter the round; data
    poisoning happens at batch packing), ``robust`` (identity-shortcut
    parameters drop the rule; a reducing rule turns the fusion kernel
    off, as the JAX package does), ``codec``, ``compute_dtype`` and
    ``local_unroll``."""
    meth = method if method is not None else methods_lib.get(cfg.method)
    compat_lib.validate(cfg, meth)
    if meth.host_fusion and (
            type(meth).init_server_state is not FedMethod.init_server_state
            or type(meth).server_update is not FedMethod.server_update):
        raise ValueError(
            f"{meth.name}: host_fusion methods end the device round at the "
            "stacked params — server_update/init_server_state never run; "
            "fold server-side work into host_fuse instead")
    dtype = params_dtype(params_like)
    layout = FlatLayout(params_like)
    ga = None
    if meth.uses_groups and task.group_axes_fn is not None:
        ga = task.group_axes_fn(params_like)
    use_kernel = use_kernel is None or bool(use_kernel)
    attack = None
    if getattr(cfg, "attack", None):
        atk = attacks_lib.parse_attack(cfg.attack).build()
        if atk.model_poisoning:
            attack = atk
    rule = None
    if getattr(cfg, "robust", None):
        rule = robust_lib.parse_robust(cfg.robust)
        if not rule.active:
            rule = None
        elif rule.reduces:
            use_kernel = False   # sort-based reductions have no kernel
    cdtype = resolve_compute_dtype(getattr(cfg, "compute_dtype", None),
                                   meth)
    codec = (codec_lib.parse_codec(cfg.codec)
             if getattr(cfg, "codec", None) else None)
    steps = cfg.local_epochs * cfg.steps_per_epoch
    ctx = MethodContext(
        task=task, cfg=cfg, population=cfg.population,
        cohort_size=cfg.cohort_size, local_steps=steps,
        opt=meth.local_opt(cfg), layout=layout, weights=None,
        raw_weights=None, group_axes=ga, group_weights=None,
        use_kernel=use_kernel,
        robust=rule if rule is not None and rule.reduces else None,
        local_unroll=resolve_local_unroll(cfg, steps),
        use_local_kernel=(bool(use_local_kernel)
                          and compat_lib.supports(meth, "kernel")))
    meth.check(ctx)
    device = torch.device(device)
    c = cfg.cohort_size
    return RoundEngine(
        cohort_size=c, method=meth, layout=layout, device=device, ctx=ctx,
        cohort=layout.alloc((c,), device=device, dtype=dtype),
        attack=attack,
        robust=ctx.robust,
        pre_rule=rule if rule is not None and rule.has_pre else None,
        codec=codec, compute_dtype=cdtype,
        shadow=(None if cdtype is None
                else layout.alloc((c,), device=device, dtype=cdtype)))
