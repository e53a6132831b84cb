"""Expert-parallel MoE: the port of ``repro.models.moe_ep`` at one shard.

The reference runs its MoE inside ``shard_map`` with an explicit
all-to-all schedule: each device routes its tokens, slots every (token,
expert) pair into a send buffer per owner shard (rank within the
destination shard, capped at ``capacity``), exchanges the buffers,
runs its local experts over a second (E_local, C, d) dispatch, and
sends the outputs back to be combined. The card is one GPU, so this
port is that schedule at ``n_shards = 1``, where both all-to-alls are
the identity. Its numbers are the reference's there, and they differ
from ``moe.moe_apply``'s: every pair's destination is shard 0, so the
first stage keeps the first ``capacity`` pairs in token order whatever
their expert (no drop at a capacity factor of 1 or more), and each
token sums its pairs in routing order. ``n_shards > 1`` waits for a
machine with more than one GPU (the all-to-all over
``torch.distributed``).
"""
from __future__ import annotations

import torch

from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import dense_apply


def _local_moe(p, xf, cfg, capacity: int):
    """The reference's per-shard body at one shard: xf (n, d) -> (y (n,
    d), aux)."""
    n, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    weights, ids, aux = moe_lib.route(dense_apply(p["router"], xf), cfg)
    flat_ids = ids.reshape(n * k)
    tok = torch.arange(n * k, device=xf.device) // k

    # first stage: every pair's destination shard is 0, so the stable
    # sort keeps token order and the first `capacity` pairs get a slot
    dest = torch.zeros_like(flat_ids)
    order, slot, _ = moe_lib.slot_pairs(dest, 1, capacity)
    # the send buffer's expert id per slot, -1 where no pair landed
    send_eid = torch.full((capacity + 1,), -1, dtype=flat_ids.dtype,
                          device=xf.device)
    send_eid = send_eid.scatter(0, slot, flat_ids[order])[:capacity]
    send_tok = torch.full((capacity + 1,), n, dtype=torch.long,
                          device=xf.device)
    send_tok = send_tok.scatter(0, slot, tok[order])[:capacity]

    # second stage: the received slots dispatched to the local experts,
    # empty slots (id -1) sorted past the last expert and never slotted
    key = torch.where(send_eid < 0, e, send_eid)
    order2, slot2, ok2 = moe_lib.slot_pairs(key, e + 1, capacity)
    ok2 = ok2 & (key[order2] < e)
    slot2 = torch.where(ok2, slot2, capacity)
    rows2 = key[order2].clamp(max=e - 1)
    buf = moe_lib.gather_buffer(xf, rows2, slot2, send_tok[order2], e,
                                capacity)
    out = moe_lib.expert_ffn(p, buf)
    # back to send-slot order (a zero row past the last for the pairs
    # the first stage dropped), then to each pair through its send slot
    back = xf.new_zeros((capacity + 1, d)).index_copy(
        0, order2, moe_lib.read_slots(out, rows2, slot2, ok2))
    pair_slot = torch.empty_like(slot).scatter(0, order, slot)
    y_pair = back[pair_slot].reshape(n, k, d)
    # order is the identity: the reference's scatter-add meets a token's
    # pairs in routing order
    y = moe_lib.combine(y_pair, weights, xf.dtype)
    if "shared" in p:
        y = y + moe_lib.swiglu(p["shared"], xf)
    return y, aux


def moe_apply_ep(p, x, cfg, *, n_shards: int = 1,
                 capacity_factor: float | None = None):
    """Expert-parallel MoE over ``n_shards`` expert shards: x (B, S, d)
    -> (y, aux). The capacity is ``max(1, int(cf * k * n / n_shards))``
    for the n = B * S tokens of the one data shard, cf
    ``capacity_factor`` or the config's. Only ``n_shards = 1`` runs."""
    if n_shards != 1:
        raise NotImplementedError(
            f"moe_apply_ep at {n_shards} shards needs the all-to-all "
            "between GPUs; it waits for a machine with more than one GPU "
            "(n_shards=1 runs here)")
    b, s, d = x.shape
    cf = capacity_factor or cfg.capacity_factor
    capacity = max(1, int(cf * cfg.top_k * b * s / n_shards))
    y, aux = _local_moe(p, x.reshape(b * s, d), cfg, capacity)
    return y.reshape(b, s, d), aux
