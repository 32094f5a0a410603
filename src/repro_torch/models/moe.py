"""Mixture-of-experts block: a softmax router, top-k experts per token,
and capacity-C grouped SwiGLU experts (the reference's mesh-less path,
`repro/models/moe.py` `_local_moe`, `_capacity` and `moe`).

Tokens are routed in groups. Within a group each expert keeps its first C
tokens in arrival order (C = `_capacity` of the group's token count) and
drops the rest; the expert products are batched matmuls over (E, G*C, d),
so a layer is a fixed number of launches whatever E is. The full-sequence
forward routes the B*S tokens as one group, as the reference does. Decode
(`per_row=True`) makes every row its own group of one token, which is the
reference's vmapped per-session step: C is 1, no token is dropped and a
row's output does not depend on the other rows.

Every gather and scatter is deterministic on the card, forward and
backward, so a step is bit-reproducible: the combine gathers each token's
top-k slot outputs and sums them in one reduction, and the dispatch
gather's backward is that same gather of the slot gradients (a plain
index backward would scatter-add with atomics).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models import common
from repro_torch.models.config import ArchConfig, Runtime


def init_moe(generator, cfg: ArchConfig, n_layers: int, device=None):
    """Stacked (n_layers, ...) weights, the reference's layout. The expert
    weights are drawn a layer at a time, so the f32 draw of one layer is
    the largest temporary (3.2 GB a matrix for qwen3-moe-235b-a22b)."""
    d, ff, E, dt, L = (cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.pdtype(),
                       n_layers)

    def w(shape, scale=0.02):
        out = torch.empty((L,) + shape, dtype=dt, device=device)
        for layer in range(L):
            out[layer] = common.normal_init(generator, shape, dt, scale,
                                            device=device)
        return out

    return {
        "norm": {"scale": torch.ones((L, d), dtype=dt, device=device)},
        "router": w((d, E)),
        "w_gate": w((E, d, ff)),
        "w_up": w((E, d, ff)),
        "w_down": w((E, ff, d), 0.02 / max(1, cfg.n_layers) ** 0.5),
    }


def _capacity(t_local: int, cfg: ArchConfig, factor: float) -> int:
    c = math.ceil(t_local * cfg.topk_experts / cfg.n_experts * factor)
    return min(t_local, max(4, c))  # decode floor of 4, never above T_local


class Routing(NamedTuple):
    """Where the tokens of G groups of T go, for E experts of capacity C.

    top_i, top_p: (G, T, K) each token's experts, best first (ties to the
    lower index), and their renormalized weights; order: (E, G, C) the
    group-local token each expert slot holds (the expert's tokens in
    arrival order, then tokens it does not take); valid: (E, G, C) the
    slot holds a token the expert takes; slot: (G, T, K) the flat (E*G*C)
    slot of each (token, expert) pair, or E*G*C where it was dropped."""

    top_i: torch.Tensor
    top_p: torch.Tensor
    order: torch.Tensor
    valid: torch.Tensor
    slot: torch.Tensor


def route(probs, k: int, capacity: int) -> Routing:
    """probs: (G, T, E) router probabilities in f32."""
    G, T, E = probs.shape
    # a stable sort breaks ties to the lower expert id, as jax.lax.top_k
    # does (torch.topk does not promise an order among ties)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :k], top_i[..., :k]
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    with torch.no_grad():
        hit = torch.zeros_like(probs, dtype=torch.bool).scatter_(
            -1, top_i, True)
        arrival = torch.cumsum(hit.to(torch.int32), dim=1) - 1
        prio = torch.where(hit, arrival, T + 1)
        order = torch.argsort(prio, dim=1, stable=True)[:, :capacity]
        valid = torch.gather(prio, 1, order) <= capacity - 1
        pos = torch.gather(arrival, -1, top_i)          # (G, T, K)
        g = torch.arange(G, device=probs.device)[:, None, None]
        slot = torch.where(pos < capacity,
                           (top_i * G + g) * capacity + pos,
                           E * G * capacity)
    return Routing(top_i, top_p, order.permute(2, 0, 1), valid.permute(
        2, 0, 1), slot)


class _Dispatch(torch.autograd.Function):
    """x_e = x[token] for every expert slot, with a deterministic backward:
    each token's gradient is the sum of its kept slots' gradients, gathered
    through `slot` (slots the expert does not take carry zero gradient)."""

    @staticmethod
    def forward(ctx, x, token, slot):
        ctx.save_for_backward(slot)
        return x[token]

    @staticmethod
    def backward(ctx, g):
        (slot,) = ctx.saved_tensors
        return _gather_slots(g.reshape(-1, g.shape[-1]), slot), None, None


def _gather_slots(rows, slot):
    """rows: (E*G*C, d) per-slot values; slot: (G, T, K) -> (G*T, d), each
    token's K slot rows summed (a dropped pair's slot reads a zero row)."""
    pad = torch.cat([rows, rows.new_zeros((1, rows.shape[-1]))])
    return pad[slot.reshape(-1, slot.shape[-1])].sum(dim=1)


def moe(p, cfg: ArchConfig, rt: Runtime, x, *, per_row: bool = False):
    """x: (B, S, d). Returns (y (B, S, d), aux balance loss).

    `per_row`: route each row of B on its own (decode, where S is 1)."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.topk_experts
    G = B if per_row else 1
    T = B * S // G
    C = _capacity(T, cfg, rt.moe_capacity)
    xf = x.reshape(G * T, d)
    logits = (xf @ p["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                      # (G*T, E)
    r = route(probs.reshape(G, T, E), K, C)

    g = torch.arange(G, device=x.device)[:, None] * T
    token = (r.order + g).reshape(E, G * C)
    x_e = _Dispatch.apply(xf, token, r.slot)                   # (E, G*C, d)
    h = torch.nn.functional.silu(torch.bmm(x_e, p["w_gate"].to(x.dtype)))
    h = h * torch.bmm(x_e, p["w_up"].to(x.dtype))
    out = torch.bmm(h, p["w_down"].to(x.dtype))                # (E, G*C, d)
    w_tok = torch.zeros_like(probs.reshape(G, T, E)).scatter(
        -1, r.top_i, r.top_p)
    w_slot = torch.gather(w_tok, 1, r.order.permute(1, 2, 0)) \
        .permute(2, 0, 1) * r.valid                            # (E, G, C)
    out = out * w_slot.reshape(E, G * C, 1).to(out.dtype)
    y = _gather_slots(out.reshape(E * G * C, d), r.slot)

    f = torch.mean(torch.zeros_like(probs).scatter_(
        -1, r.top_i.reshape(G * T, K), 1.0), dim=0)
    aux = E * torch.sum(f * torch.mean(probs, dim=0))
    return y.reshape(B, S, d), aux
