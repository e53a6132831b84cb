"""Federated round engine on one device.

One round over a fixed-width COHORT of client slots (width =
``cfg.cohort_size``; the engine never sees the logical population):

    stacked <- broadcast(global)               # round start
    stacked, cstate <- method.client_update(stacked, batches, cstate)
    fused   <- method.fuse(stacked)            # the only cross-cohort op
    sstate, global <- method.server_update(sstate, fused)
    global  <- method.host_fuse(stacked)       # host_fusion methods only

The cohort lives in ONE flat (C, M) buffer (rows = clients, per-leaf
views through ``FlatLayout``), allocated once and reused every round:
broadcast is one copy into it, the local phase takes a vmapped gradient
over its rows, the ``local_step`` kernel route updates it in place, and
the fusion reads it in one ``paired_fusion`` launch when all leaves share
the sample weights.

The method comes from the fl/methods.py registry; the engine never
branches on its name. Because cohorts are sampled each round, the
per-slot fusion weights ``w`` (and fed2's presence rows ``gw``) are round
arguments: fusion renormalizes them over the participants it sees.

For rounds whose participant set exceeds one cohort (cohort tiling),
``run_tile`` executes local phase + fuse for one tile, and
``finish_round`` applies the server step once to the tiles' combined
fusion result (``host_fuse`` once to the tiles' stacked params, for
host-fusion methods).

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
from repro_torch.fl import methods as methods_lib
from repro_torch.fl.methods import FedMethod, MethodContext
from repro_torch.models.module import FlatLayout, tree_map


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
    sample weights (and fed2 presence rows) in slot order."""
    cohort_size: int
    method: FedMethod
    layout: FlatLayout
    device: torch.device
    ctx: MethodContext
    cohort: torch.Tensor          # the reusable (C, M) buffer

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

    def _local_and_fuse(self, clients_state, server_state, global_params,
                        batches, weights, group_weights):
        """The shared cohort-tile body: broadcast -> local phase -> fuse.
        Returns (clients_state on the device, new client states, fuse
        output, the round's context)."""
        ctx = dataclasses.replace(self.ctx, weights=self._w32(weights),
                                  group_weights=self._w32(group_weights))
        clients_state = self._to_device(clients_state)
        stacked = fusion_lib.broadcast_global(global_params, self.cohort)
        stacked, new_clients = self.method.client_update(
            stacked, batches, global_params, clients_state, server_state,
            ctx)
        fused = self.method.fuse(stacked, global_params, ctx)
        return clients_state, new_clients, fused, ctx

    def run_round(self, state, global_params, batches, weights=None,
                  group_weights=None) -> tuple:
        """One whole round. For host-fusion methods the round ends in
        ``host_fuse`` with the participants' raw ``weights``."""
        old_clients, new_clients, fused, ctx = self._local_and_fuse(
            state["clients"], state["server"], global_params, batches,
            weights, group_weights)
        new_server, out = self.method.server_update(
            state["server"], old_clients, new_clients, global_params,
            fused, ctx)
        if self.method.host_fusion:
            out = self.host_fuse(out, weights)
        return {"server": new_server, "clients": new_clients}, out

    def run_tile(self, client_states, server_state, global_params,
                 batches, weights=None, group_weights=None) -> tuple:
        """One cohort tile of a tiled round: local phase + fuse only.
        Returns (new_client_states, fuse output)."""
        _, new_clients, fused, _ = self._local_and_fuse(
            client_states, server_state, global_params, batches, weights,
            group_weights)
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
    ``fused_local_step``."""
    meth = method if method is not None else methods_lib.get(cfg.method)
    if meth.host_fusion and (
            type(meth).init_server_state is not FedMethod.init_server_state
            or type(meth).server_update is not FedMethod.server_update):
        raise ValueError(
            f"{meth.name}: host_fusion methods end the device round at the "
            "stacked params — server_update/init_server_state never run; "
            "fold server-side work into host_fuse instead")
    layout = FlatLayout(params_like)
    ga = None
    if meth.uses_groups and task.group_axes_fn is not None:
        ga = task.group_axes_fn(params_like)
    ctx = MethodContext(
        task=task, cfg=cfg, population=cfg.population,
        cohort_size=cfg.cohort_size,
        local_steps=cfg.local_epochs * cfg.steps_per_epoch,
        opt=meth.local_opt(cfg), layout=layout, weights=None,
        raw_weights=None, group_axes=ga, group_weights=None,
        use_kernel=use_kernel is None or bool(use_kernel),
        use_local_kernel=bool(use_local_kernel) and meth.fused_local_step)
    meth.check(ctx)
    device = torch.device(device)
    return RoundEngine(
        cohort_size=cfg.cohort_size, method=meth, layout=layout,
        device=device, ctx=ctx,
        cohort=layout.alloc((cfg.cohort_size,), device=device))
