"""Mixture-of-Experts FFN: top-k routing with capacity, sort-based dispatch.

The reference package's ``repro.models.moe`` on one device, step for step:
tokens split into ``G = cfg.moe_groups`` groups (1 when ``N % G != 0``),
each routed privately: float32 router logits, softmax, top-k,
renormalized weights; the group's (token, slot) assignments sorted by
expert (a stable sort), ranked within their expert, and dropped past the
per-expert capacity; kept tokens written into a dense (E, cap, D) buffer,
the experts' FFNs run as batched products, and each token's k outputs
summed back with its router weights.  The reference's
``logical_constraint`` (mesh sharding hints) has no meaning on one GPU.

**Order decides bits here**, and the port keeps the reference's:

* Router logits are a float32 product with TF32 off on the card (the
  product decides routing): :func:`moe_route` sets float32 matmul
  precision to ``"highest"`` around it and restores it after.
* Top-k breaks a tie toward the lower expert, as ``jax.lax.top_k`` does:
  a stable descending sort, first k (``torch.topk``'s order on ties is
  unspecified on the card).
* The combine (the reference's ``.at[src].add``, which XLA applies in
  update order) folds each token's k contributions one at a time in
  ascending position of the expert-sorted order, in the activation dtype,
  from zeros: :func:`moe_combine`, k gathers and k adds, no atomics
  (``index_add_`` on the card adds in no fixed order).
  :func:`moe_combine_ref` is the plain version: one add per contribution,
  in update order.

Dropped (token, slot) pairs point at a sentinel row ``E * cap`` of the
expert outputs, zeros, as in the reference.  :func:`moe_init` draws the
reference's shapes with its fan-in rule (``shape[0]``: the expert count
for the (E, D, F) weights).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, gelu_tanh

__all__ = [
    "moe_init", "moe_apply", "moe_parts", "moe_route", "moe_dispatch",
    "moe_combine", "moe_combine_ref", "capacity", "routing_flips",
    "top_k_margin", "Route", "Dispatch", "Parts",
]


def moe_init(cfg: ModelConfig, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """``router`` (D, E) float32, ``w_in`` / ``w_gate`` (E, D, F) and
    ``w_out`` (E, F, D) in the parameter dtype (``w_gate`` for the gated
    kinds only)."""
    D, F_, E, pd = cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.pdtype
    p = {
        "router": dense_init((D, E), torch.float32, generator),
        "w_in": dense_init((E, D, F_), pd, generator),
        "w_out": dense_init((E, F_, D), pd, generator),
    }
    if cfg.mlp in ("swiglu", "geglu"):
        p["w_gate"] = dense_init((E, D, F_), pd, generator)
    return p


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for a group of ``n_tokens``:
    ``max(8, round_up_8(int(n * k * cf / E)))``."""
    cap = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(8, ((cap + 7) // 8) * 8)


def _groups(n_tokens: int, cfg: ModelConfig) -> int:
    G = cfg.moe_groups if n_tokens % max(cfg.moe_groups, 1) == 0 else 1
    return max(G, 1)


class Route(NamedTuple):
    """A group-local routing: all (G, Ng, ·)."""

    logits: torch.Tensor  # (G, Ng, E) float32
    probs: torch.Tensor   # (G, Ng, E) float32
    topw: torch.Tensor    # (G, Ng, k) float32, renormalized
    topi: torch.Tensor    # (G, Ng, k) int64, descending probability


def moe_route(router: torch.Tensor, xf: torch.Tensor, k: int) -> Route:
    """Router logits of ``xf`` (G, Ng, D) in float32 (TF32 off), softmax,
    top-k (ties to the lower expert), weights renormalized with a 1e-9
    floor."""
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        logits = xf.to(torch.float32) @ router
    finally:
        torch.set_float32_matmul_precision(precision)
    # jax.nn.softmax's arithmetic: exp(x - max) / sum
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = e / e.sum(-1, keepdim=True)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = vals[..., :k], idx[..., :k]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return Route(logits, probs, topw, topi)


class Dispatch(NamedTuple):
    """Where each of a group's M = Ng * k (token, slot) pairs goes, in
    expert-sorted order: all (G, M)."""

    order: torch.Tensor      # flat (token, slot) index of each sorted pair
    dest: torch.Tensor       # expert * cap + rank, or E * cap when dropped
    keep: torch.Tensor       # bool: rank < cap
    src_token: torch.Tensor  # order // k


def moe_dispatch(topi: torch.Tensor, cap: int, num_experts: int) -> Dispatch:
    """Stable sort of the flattened expert ids, rank within each expert
    (position minus its run's start, the start by a cumulative max), the
    capacity cut and the destination rows."""
    G, Ng, k = topi.shape
    M = Ng * k
    flat_e = topi.reshape(G, M)
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    iota = torch.arange(M, device=topi.device).expand(G, M)
    is_start = torch.ones_like(sorted_e, dtype=torch.bool)
    is_start[:, 1:] = sorted_e[:, 1:] != sorted_e[:, :-1]
    seg_start = torch.cummax(torch.where(is_start, iota, 0), dim=1).values
    pos_in_e = iota - seg_start
    keep = pos_in_e < cap
    dest = torch.where(keep, sorted_e * cap + pos_in_e, num_experts * cap)
    return Dispatch(order, dest, keep, order // k)


def moe_combine(contrib: torch.Tensor, order: torch.Tensor, k: int) -> torch.Tensor:
    """Each token's sum of its k contributions ``contrib`` (G, M, D), M in
    expert-sorted order, added one at a time in ascending sorted position
    from zeros, in ``contrib``'s dtype: (G, Ng, D).  The k sorted positions
    of each token come from the inverse of ``order``."""
    G, M, D = contrib.shape
    inv = torch.argsort(order, dim=1)                 # sorted position of n*k + j
    pos = torch.sort(inv.reshape(G, M // k, k), dim=-1).values
    out = torch.zeros((G, M // k, D), dtype=contrib.dtype, device=contrib.device)
    for j in range(k):
        idx = pos[..., j:j + 1].expand(-1, -1, D)
        out = out + torch.gather(contrib, 1, idx)
    return out


def moe_combine_ref(contrib: torch.Tensor, src_token: torch.Tensor,
                    n_tokens: int) -> torch.Tensor:
    """Plain version of :func:`moe_combine`: ``out[src[m]] += contrib[m]``
    for m = 0, 1, ... of each group, one add a contribution (slow)."""
    G, M, D = contrib.shape
    out = torch.zeros((G, n_tokens, D), dtype=contrib.dtype,
                      device=contrib.device)
    src = src_token.tolist()
    for g in range(G):
        for m in range(M):
            t = src[g][m]
            out[g, t] = out[g, t] + contrib[g, m]
    return out


def _expert_ffn(p, buf: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(G, E, cap, D) -> (G, E, cap, D) through each expert's FFN."""
    h = torch.einsum("gecd,edf->gecf", buf, p["w_in"])
    if cfg.mlp == "swiglu":
        h = F.silu(torch.einsum("gecd,edf->gecf", buf, p["w_gate"])) * h
    elif cfg.mlp == "geglu":
        h = gelu_tanh(torch.einsum("gecd,edf->gecf", buf, p["w_gate"])) * h
    else:
        h = F.relu(h)
    return torch.einsum("gecf,efd->gecd", h, p["w_out"])


class Parts(NamedTuple):
    """One MoE pass up to its combine: the routing, the dispatch, and each
    (token, slot) pair's weighted expert output ``contrib`` (G, M, D) in
    expert-sorted order (zeros for a dropped pair)."""

    route: Route
    dispatch: Dispatch
    contrib: torch.Tensor


def moe_parts(p, x: torch.Tensor, cfg: ModelConfig) -> Parts:
    """Route, dispatch and run the experts on x (B, S, D)."""
    B, S, D = x.shape
    N = B * S
    E, k = cfg.num_experts, cfg.top_k
    G = _groups(N, cfg)
    Ng = N // G
    cap = capacity(Ng, cfg)

    xf = x.reshape(G, Ng, D)
    route = moe_route(p["router"], xf, k)
    d = moe_dispatch(route.topi, cap, E)
    gathered_in = torch.gather(xf, 1, d.src_token[..., None].expand(-1, -1, D))
    # row E * cap takes every dropped pair's write and is cut off: kept
    # destinations are distinct, so the buffer's rows are each written once
    buf = torch.zeros((G, E * cap + 1, D), dtype=x.dtype, device=x.device)
    buf.scatter_(1, d.dest[..., None].expand(-1, -1, D), gathered_in)
    buf = buf[:, :E * cap].reshape(G, E, cap, D)

    out_buf = _expert_ffn(p, buf, cfg).reshape(G, E * cap, D)
    out_buf = torch.cat([out_buf, out_buf.new_zeros((G, 1, D))], dim=1)
    gathered = torch.gather(out_buf, 1, d.dest[..., None].expand(-1, -1, D))
    w = (torch.gather(route.topw.reshape(G, Ng * k), 1, d.order)
         * d.keep).to(x.dtype)
    return Parts(route, d, gathered * w[..., None])


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """x (B, S, D) -> (out (B, S, D) in x's dtype, aux): ``moe_lb_loss``
    (Switch-style load balance), ``moe_z_loss`` (router z-loss) and
    ``moe_dropped_frac``, float32 scalars."""
    B, S, D = x.shape
    N = B * S
    E, k = cfg.num_experts, cfg.top_k
    route, d, contrib = moe_parts(p, x, cfg)
    me = route.probs.mean((0, 1))
    ce = torch.bincount(route.topi.reshape(-1), minlength=E).to(torch.float32) / (N * k)
    aux = {
        "moe_lb_loss": E * torch.sum(me * ce),
        "moe_z_loss": torch.mean(torch.logsumexp(route.logits, dim=-1) ** 2),
        "moe_dropped_frac": 1.0 - d.keep.to(torch.float32).mean(),
    }
    return moe_combine(contrib, d.order, k).reshape(B, S, D), aux


def top_k_margin(probs: torch.Tensor, k: int) -> torch.Tensor:
    """How near a top-k decision is to a tie: (p_k - p_k+1) / p_k of the
    k-th and (k+1)-th largest router probabilities, float64, over the last
    axis."""
    top = torch.sort(probs.double(), dim=-1, descending=True).values
    return (top[..., k - 1] - top[..., k]) / top[..., k - 1]


def routing_flips(run_a, run_b, positions):
    """Where two runs of the same prompts routed differently, call by call
    (a call is one MoE layer of one forward pass; ``positions[c]`` holds
    the positions of call c's S tokens).  Each run is a list over calls of
    (topi (B, S, k), kept (B, S): how many of the k slots were kept).

    A sequence is routed alike until a decision of it -- its top-k set or
    its kept count -- differs at some call; from then on its later calls
    differ at that position and after as a consequence (causal attention
    and the capacity rank carry a difference only forward, and the next
    layers see it).  Returns ``(flips, first)``: the (call, sequence,
    index) of every top-k difference at a position still routed alike,
    and {sequence: its first position routed differently}.  A kept count
    can differ only in a call where some top-k set does (capacity is
    shared by the call's tokens): ``ValueError`` otherwise."""
    never = 2 ** 62
    flips, limit = [], None
    for c, ((ta, ka), (tb, kb)) in enumerate(zip(run_a, run_b)):
        pos = torch.as_tensor(positions[c], device=ta.device, dtype=torch.int64)
        if limit is None:
            limit = torch.full((ta.shape[0],), never, device=ta.device)
        diff_set = (torch.sort(ta, -1).values
                    != torch.sort(tb, -1).values).any(-1)
        diff_keep = (ka != kb) | diff_set
        if bool(diff_keep.any()) and not bool(diff_set.any()):
            raise ValueError(f"call {c}: a kept count differs, no top-k set")
        clean = pos[None, :] < limit[:, None]
        flips += [(c, b, t) for b, t in (diff_set & clean).nonzero().tolist()]
        limit = torch.minimum(limit, torch.where(diff_keep, pos, never).amin(1))
    first = {b: p for b, p in enumerate(limit.tolist()) if p != never}
    return flips, first
