"""Mixture-of-Experts FFN with sort-based capacity dispatch: the port of
``repro.models.moe``.

Dispatch builds an (E, C, d) buffer (the (token, expert) pairs sorted by
expert with a stable sort, each slotted at its rank within its expert,
pairs at or past ``capacity`` dropped), runs every expert's SwiGLU over
its C rows as three batched products, and combines each token's pairs
with their router weights. Routing is Mixtral's top-k softmax (weights
renormalized over the top k) or DeepSeek-V2's (softmax then top-k, plus
always-on shared experts fused into one SwiGLU).

Every shape is static (capacity depends only on the token count, k, E
and the factor) and every index operation is out of place, so the round
engine's ``torch.func.vmap(grad(...))`` batches the dispatch over
clients: the per-expert counts are a one-hot sum into a fixed (E,)
vector (no ``bincount``), and the buffer is a gather of the tokens
through a slot -> token map of ``capacity + 1`` rows per expert, whose
last row takes the dropped pairs and is cut off (the reference's
``.at[...].set(mode="drop")``); the combine reads a dropped pair's slot
clamped and masks it, as the reference does.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.layers import dense_apply, dense_init, silu
from repro_torch.models.module import default_init, rematerialized


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff_expert: int
    n_experts: int
    top_k: int
    n_shared: int = 0            # deepseek-v2: 2 shared experts
    d_ff_shared: int = 0         # hidden dim of the fused shared expert
    capacity_factor: float = 1.25
    router_norm_topk: bool = True  # mixtral renormalizes over top-k


def moe_init(gen, cfg: MoEConfig, dtype=torch.float32):
    """The router (d, E), the stacked expert SwiGLU weights w_gate, w_up
    (E, d, f) and w_down (E, f, d), and with ``n_shared`` the fused
    shared expert (a SwiGLU of hidden width ``d_ff_shared``, default
    ``n_shared * d_ff_expert``)."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    p = {"router": dense_init(gen, d, e, dtype=dtype),
         "w_gate": default_init(gen, (e, d, f), fan_in=d, dtype=dtype),
         "w_up": default_init(gen, (e, d, f), fan_in=d, dtype=dtype),
         "w_down": default_init(gen, (e, f, d), fan_in=f, dtype=dtype)}
    if cfg.n_shared > 0:
        fs = cfg.d_ff_shared or cfg.n_shared * cfg.d_ff_expert
        p["shared"] = {"w_gate": dense_init(gen, d, fs, dtype=dtype),
                       "w_up": dense_init(gen, d, fs, dtype=dtype),
                       "w_down": dense_init(gen, fs, d, dtype=dtype)}
    return p


def _one_hot(ids, e: int):
    """(..., E) fp32 one-hot of ``ids`` by comparison (vmap batches it;
    ``F.one_hot`` reads the ids' range on the host)."""
    return (ids[..., None] == torch.arange(e, device=ids.device)).to(
        torch.float32)


def route(router_logits, cfg: MoEConfig):
    """router_logits (N, E) -> (weights (N, k) fp32, ids (N, k), aux).

    fp32 softmax, then the k largest probabilities, ties to the lower
    expert index (``jax.lax.top_k``'s order: a stable descending sort;
    ``torch.topk`` promises no order among ties), renormalized over the
    k with ``router_norm_topk``. aux is the Switch load-balance loss
    E * sum_e (share of tokens whose first choice is e) * (mean
    probability of e)."""
    probs = torch.softmax(router_logits.to(torch.float32), dim=-1)
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[..., :cfg.top_k], ids[..., :cfg.top_k]
    if cfg.router_norm_topk:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    e = router_logits.shape[-1]
    frac_tokens = _one_hot(ids[:, 0], e).mean(dim=0)
    frac_probs = probs.mean(dim=0)
    return weights, ids, e * (frac_tokens * frac_probs).sum()


def swiglu(p, x):
    return dense_apply(p["w_down"], silu(dense_apply(p["w_gate"], x))
                       * dense_apply(p["w_up"], x))


def expert_ffn(p, buf):
    """Every expert's SwiGLU over its rows: buf (E, C, d) -> (E, C, d),
    the reference's three einsums as batched products."""
    h = silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    return torch.bmm(h, p["w_down"])


def slot_pairs(keys, n_keys: int, capacity: int):
    """The reference's rank-within-key slotting of (n*k,) ``keys`` in
    [0, n_keys): (order, slot, ok), where ``order`` is the stable sort
    of the keys, and the pair at sorted position i takes slot ``slot[i]``
    of its key (its rank among that key's pairs), or ``capacity`` (the
    overflow row) where ``ok[i]`` is False."""
    order = torch.argsort(keys, stable=True)
    sorted_k = keys[order]
    counts = _one_hot(keys, n_keys).sum(dim=0).to(keys.dtype)
    offsets = torch.cumsum(counts, dim=0) - counts
    rank = torch.arange(keys.shape[0], device=keys.device) - offsets[sorted_k]
    ok = rank < capacity
    return order, torch.where(ok, rank, capacity), ok


def gather_buffer(xf, rows, slot, tok, n_rows: int, capacity: int):
    """The (n_rows, capacity, d) dispatch buffer: pair i's token
    ``xf[tok[i]]`` at row ``rows[i]``, slot ``slot[i]``; slots no pair
    takes hold zeros, and the overflow slot ``capacity`` (where the
    dropped pairs land) is cut off."""
    n, d = xf.shape
    src = torch.full((n_rows * (capacity + 1),), n, dtype=torch.long,
                     device=xf.device)
    src = src.scatter(0, rows * (capacity + 1) + slot, tok)
    xp = torch.cat([xf, xf.new_zeros((1, d))])
    return xp[src].reshape(n_rows, capacity + 1, d)[:, :capacity]


def read_slots(out, rows, slot, ok):
    """out[rows, slot] (n, d), 0 where not ``ok``: a dropped pair's
    overflow slot is read clamped and masked, as the reference does."""
    got = out[rows, slot.clamp(max=out.shape[1] - 1)]
    return torch.where(ok[:, None], got, 0)


def combine(y_pair, weights, dtype, order=None):
    """Each token's k expert outputs y_pair (n, k, d), weighted in
    ``dtype`` and summed one by one in ``dtype``, in the order of
    ``order`` (n, k) (default: routing order)."""
    contrib = y_pair * weights.to(dtype)[..., None]
    if order is not None:
        contrib = torch.take_along_dim(contrib, order[..., None], dim=1)
    y = contrib[:, 0]
    for j in range(1, contrib.shape[1]):
        y = y + contrib[:, j]
    return y


def moe_apply(p, x, cfg: MoEConfig, *, chunk_tokens: int = 32768):
    """x (B, S, d) -> (y (B, S, d), aux).

    Each expert takes ``max(1, int(capacity_factor * k * n / E))`` of
    the n = B * S tokens' pairs, all n * k in decode (S == 1). Above
    ``chunk_tokens`` tokens (S > 1) the tokens are right-padded with
    zeros to whole chunks and dispatched chunk by chunk, each chunk
    rematerialized on the plain-autograd route: the zero padding tokens
    route too and take capacity in the last chunk, and aux is the mean
    of the chunks' (the reference's ``lax.scan``)."""
    b, s, d = x.shape
    n = b * s
    if n > chunk_tokens and s > 1:
        nc = -(-n // chunk_tokens)
        xf = torch.cat([x.reshape(n, d),
                        x.new_zeros((nc * chunk_tokens - n, d))])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        ys = []
        for xc in xf.reshape(nc, 1, chunk_tokens, d).unbind(0):
            y, a = rematerialized(lambda p_, xc_: moe_apply(p_, xc_, cfg),
                                  p, xc)
            ys.append(y[0])
            aux = aux + a
        return torch.cat(ys)[:n].reshape(b, s, d), aux / nc
    xf = x.reshape(n, d)
    weights, ids, aux = route(dense_apply(p["router"], xf), cfg)
    e, k = cfg.n_experts, cfg.top_k
    capacity = n * k if s == 1 else max(
        1, int(cfg.capacity_factor * k * n / e))

    flat_ids = ids.reshape(n * k)
    tok = torch.arange(n * k, device=x.device) // k
    order, slot, _ = slot_pairs(flat_ids, e, capacity)
    buf = gather_buffer(xf, flat_ids[order], slot, tok[order], e, capacity)
    out = expert_ffn(p, buf)
    # each pair's slot, back in (token, choice) order
    pair_slot = torch.empty_like(slot).scatter(0, order, slot)
    y_pair = read_slots(out, flat_ids, pair_slot,
                        pair_slot < capacity).reshape(n, k, d)
    # ascending expert order: the order in which the reference's
    # scatter-add over the expert-sorted pairs meets a token's pairs
    y = combine(y_pair, weights, x.dtype,
                torch.sort(ids, dim=1, stable=True)[1])
    if "shared" in p:
        y = y + swiglu(p["shared"], xf)
    return y.reshape(b, s, d), aux


def moe_apply_dense_reference(p, x, cfg: MoEConfig):
    """The O(E) dense oracle of the tests: every expert on every token,
    combined with the top-k weights in fp32; equal to ``moe_apply`` up
    to capacity drops."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    weights, ids, aux = route(dense_apply(p["router"], xf), cfg)
    g = torch.einsum("nd,edf->enf", xf, p["w_gate"])
    u = torch.einsum("nd,edf->enf", xf, p["w_up"])
    out = torch.einsum("enf,efd->end", silu(g) * u, p["w_down"])
    mask = _one_hot(ids, cfg.n_experts)                    # (N, k, E)
    y = torch.einsum("nk,nke,end->nd", weights, mask,
                     out.to(torch.float32)).to(x.dtype)
    if "shared" in p:
        y = y + swiglu(p["shared"], xf)
    return y.reshape(b, s, d), aux
