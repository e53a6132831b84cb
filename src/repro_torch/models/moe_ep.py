"""Expert-parallel MoE: the port of ``repro.models.moe_ep``.

The reference runs its MoE inside ``shard_map`` with an explicit
all-to-all schedule. Tokens are split over the mesh's "data" axis and
replicated over "model", whose ``nsh`` shards own ``E / nsh`` experts
each. On each shard:

1. route the local tokens; a pair's destination is its expert's owner;
2. slot every (token, expert) pair into a (nsh, capacity, d) send
   buffer, at its rank within its destination shard (pairs at or past
   ``capacity`` drop), with the owner-local expert id beside it;
3. all-to-all over "model": the tokens for this shard's experts from
   every peer;
4. a second dispatch into an (E_local, nsh * capacity, d) buffer, the
   local experts' SwiGLU over it (the weights sliced at this shard's
   experts, ``convert.expert_shard``), read back into receive order;
5. the reverse all-to-all: each pair's output back in its send slot;
6. each token's pairs weighted and summed in the reference's
   scatter-add order (by destination shard, then routing order).

``moe_apply_ep`` runs it on one rank of a ``launch/mesh.RankMesh`` (the
all-to-alls of ``launch/collectives.py``), or at one shard without a
mesh, where both all-to-alls are the identity; there its numbers
differ from ``moe.moe_apply``'s: every pair's destination is shard 0,
so the first stage keeps the first ``capacity`` pairs in token order
whatever their expert. ``moe_apply_ep_plain`` is the same schedule in
one process over every (data, model) shard, each all-to-all an index
transpose of the stacked (nsh, nsh, capacity, d) buffers: the
reference's numbers on one device, and the ranks' to the bit (they run
its per-shard ops).
"""
from __future__ import annotations

import torch

from repro_torch.convert import expert_shard
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import dense_apply, silu


def _dispatch(p, xf, cfg, capacity: int, nsh: int) -> tuple:
    """Stages 1-2 on one shard, xf (n, d): the send buffer (nsh,
    capacity, d), its owner-local expert ids (nsh, capacity) (-1 where
    no pair landed), and what the combine needs: (weights, the pairs'
    destinations, the destination sort, each sorted pair's slot and
    whether it was kept, aux)."""
    n, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    e_loc = e // nsh
    weights, ids, aux = moe_lib.route(dense_apply(p["router"], xf), cfg)
    flat_ids = ids.reshape(n * k)
    tok = torch.arange(n * k, device=xf.device) // k
    dest = flat_ids // e_loc
    order, slot, ok = moe_lib.slot_pairs(dest, nsh, capacity)
    sdest = dest[order]
    send = moe_lib.gather_buffer(xf, sdest, slot, tok[order], nsh,
                                 capacity)
    send_eid = torch.full((nsh * (capacity + 1),), -1,
                          dtype=flat_ids.dtype, device=xf.device)
    send_eid = send_eid.scatter(0, sdest * (capacity + 1) + slot,
                                flat_ids[order] % e_loc)
    send_eid = send_eid.reshape(nsh, capacity + 1)[:, :capacity]
    return send, send_eid, (weights, dest, order, slot, ok, aux)


def _experts(p_loc, recv, recv_eid):
    """Stage 4 on one shard: the received (nsh, capacity, d) tokens
    through this shard's experts (``p_loc``'s E_local), back in receive
    order; the empty slots (id -1) read zeros."""
    nsh, cap, d = recv.shape
    e_loc = p_loc["w_gate"].shape[0]
    cap2 = nsh * cap              # worst case: every pair to one expert
    re = recv.reshape(cap2, d)
    key = recv_eid.reshape(cap2)
    key = torch.where(key < 0, e_loc, key)
    order2, slot2, ok2 = moe_lib.slot_pairs(key, e_loc + 1, cap2)
    ok2 = ok2 & (key[order2] < e_loc)
    slot2 = torch.where(ok2, slot2, cap2)
    rows2 = key[order2].clamp(max=e_loc - 1)
    buf = moe_lib.gather_buffer(re, rows2, slot2, order2, e_loc, cap2)
    # expert_ffn's three products, the buffer (the schedule's largest
    # tensor) freed before the down product's output is made
    h = silu(torch.bmm(buf, p_loc["w_gate"])) * torch.bmm(buf, p_loc["w_up"])
    del buf
    out = torch.bmm(h, p_loc["w_down"])
    back = re.new_zeros((cap2, d)).index_copy(
        0, order2, moe_lib.read_slots(out, rows2, slot2, ok2))
    return back.reshape(nsh, cap, d)


def _combine(p, xf, ret, state):
    """Stage 6 on one shard: each pair's output read from its send slot
    of ``ret`` (nsh, capacity, d) (0 for a dropped pair), weighted and
    summed per token in the reference's scatter-add order, plus the
    shared expert."""
    n, d = xf.shape
    weights, dest, order, slot, ok, _ = state
    k = weights.shape[1]
    got = moe_lib.read_slots(ret, dest[order], slot, ok)
    y_pair = torch.empty_like(got).index_copy(0, order, got).reshape(n, k,
                                                                     d)
    # the scatter-add runs over the destination-sorted pairs: a token
    # meets its pairs by destination shard, then in routing order
    by_dest = torch.sort(dest.reshape(n, k), dim=1, stable=True)[1]
    y = moe_lib.combine(y_pair, weights, xf.dtype, by_dest)
    if "shared" in p:
        y = y + moe_lib.swiglu(p["shared"], xf)
    return y


def capacity_of(cfg, n_loc: int, nsh: int, capacity_factor=None) -> int:
    """The reference's send capacity for ``n_loc`` tokens a data shard
    over ``nsh`` expert shards: ``max(1, int(cf * k * n_loc / nsh))``,
    cf ``capacity_factor`` or the config's."""
    cf = capacity_factor or cfg.capacity_factor
    return max(1, int(cf * cfg.top_k * n_loc / nsh))


def _check_shards(cfg, nsh: int) -> None:
    if cfg.n_experts % nsh:
        raise ValueError(f"{cfg.n_experts} experts do not split over "
                         f"{nsh} expert shards")


def moe_apply_ep(p, x, cfg, *, mesh=None, capacity_factor=None):
    """Expert-parallel MoE on this rank: x (B_loc, S, d) -> (y, aux).

    ``mesh``: a ``launch/mesh.RankMesh``; x is then this rank's data
    shard (its "data" coordinate's B / |data| sequences) and the experts
    split over "model". ``p``'s expert leaves hold all E experts (the
    reference's replicated weights, sliced here) or this rank's E /
    |model| (``convert.expert_shard``). Without a mesh, one shard of
    all the tokens."""
    b, s, d = x.shape
    nsh = 1 if mesh is None else mesh.shape["model"]
    _check_shards(cfg, nsh)
    capacity = capacity_of(cfg, b * s, nsh, capacity_factor)
    xf = x.reshape(b * s, d)
    send, send_eid, state = _dispatch(p, xf, cfg, capacity, nsh)
    if nsh > 1:
        from repro_torch.launch.collectives import all_to_all
        recv = all_to_all(send, mesh, "model")
        recv_eid = all_to_all(send_eid, mesh, "model")
    else:
        recv, recv_eid = send, send_eid
    p_loc = p
    if p["w_gate"].shape[0] == cfg.n_experts and nsh > 1:
        p_loc = expert_shard(p, mesh.coord("model"), nsh)
    back = _experts(p_loc, recv, recv_eid)
    ret = back if nsh == 1 else all_to_all(back, mesh, "model")
    y = _combine(p, xf, ret, state)
    return y.reshape(b, s, d), state[-1]


def moe_apply_ep_plain(p, x, cfg, *, data: int = 1, model: int = 1,
                       capacity_factor=None):
    """The schedule of ``moe_apply_ep`` over a (data, model) mesh in one
    process: x (B, S, d), B split over ``data`` -> (y, aux). Every
    (data, model) shard runs the ranks' ops; each all-to-all is the
    index transpose of the shards' stacked (nsh, nsh, capacity, d)
    buffers. The model shards of a data shard hold the same tokens, so
    their outputs are equal; y is model shard 0's, and aux data shard
    0's (the value the reference's replicated out spec returns)."""
    b, s, d = x.shape
    if b % data:
        raise ValueError(f"batch {b} does not split over {data} data "
                         "shards")
    _check_shards(cfg, model)
    bl = b // data
    capacity = capacity_of(cfg, bl * s, model, capacity_factor)
    ys, aux = [], None
    for di in range(data):
        xf = x[di * bl:(di + 1) * bl].reshape(bl * s, d)
        sends = [_dispatch(p, xf, cfg, capacity, model)
                 for _ in range(model)]
        send = torch.stack([sd[0] for sd in sends])     # (src, dst, ...)
        send_eid = torch.stack([sd[1] for sd in sends])
        backs = torch.stack([
            _experts(expert_shard(p, j, model), send[:, j], send_eid[:, j])
            for j in range(model)])                     # (dst, src, ...)
        y = _combine(p, xf, backs[:, 0], sends[0][2])
        ys.append(y.reshape(bl, s, d))
        if di == 0:
            aux = sends[0][2][-1]
    return torch.cat(ys), aux
