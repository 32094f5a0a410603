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
row's output does not depend on the other rows. On a training mesh
(`moe_mesh`) the experts split over 'model' (expert parallelism): each
position runs its E/model experts on its batch shard's tokens.

Every gather and scatter is deterministic on the card, forward and
backward, so a step is bit-reproducible: the combine gathers each token's
top-k slot outputs and sums them in one reduction, and its backward
gathers each slot's token gradient; the dispatch gather's backward is
the combine's gather of the slot gradients (a plain index backward would
scatter-add with atomics).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch import mesh as mesh_mod
from repro_torch.models import common, tp
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


def moe_spec(cfg: ArchConfig):
    """One layer's layouts (`common.norm_spec`), the reference's
    `moe_spec`: the experts over 'model'."""
    return {
        "norm": common.norm_spec(cfg.norm),
        "router": (None, None),
        "w_gate": ("model", "data", None),
        "w_up": ("model", "data", None),
        "w_down": ("model", None, "data"),
    }


def moe_reads(cfg: ArchConfig, lay):
    """`moe_spec`'s leaves a position of `lay` reads as exactly its
    'model' block (`common.block_reads`): its E/model experts wherever
    'model' has more than one position (`moe_mesh`)."""
    split = lay.n_model > 1
    return common.block_reads(moe_spec(cfg), w_gate=split, w_up=split,
                              w_down=split)


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


class _Combine(torch.autograd.Function):
    """`_gather_slots` with a deterministic backward: a slot that holds a
    token takes that token's gradient, gathered through `token`, and a
    slot that holds none (`valid` false) takes zero. A plain index
    backward would scatter every dropped pair's gradient onto the one
    zero pad row, serialized, and on a mesh every pair of another
    position's experts is such a pair."""

    @staticmethod
    def forward(ctx, rows, slot, token, valid):
        ctx.save_for_backward(token, valid)
        return _gather_slots(rows, slot)

    @staticmethod
    def backward(ctx, g):
        token, valid = ctx.saved_tensors
        gr = torch.where(valid.reshape(-1, 1), g[token.reshape(-1)], 0)
        return gr, None, None, None


def moe(p, cfg: ArchConfig, rt: Runtime, x, *, per_row: bool = False):
    """x: (B, S, d). Returns (y (B, S, d), aux balance loss).

    `per_row`: route each row of B on its own (decode, where S is 1)."""
    B, S, d = x.shape
    G = B if per_row else 1
    C = _capacity(B * S // G, cfg, rt.moe_capacity)
    y, aux = _experts(p, cfg, x.reshape(B * S, d), G, C, 0,
                      (p["w_gate"], p["w_up"], p["w_down"]))
    return y.reshape(B, S, d), aux


def _experts(p, cfg: ArchConfig, xf, G: int, C: int, e_off: int, ws):
    """Route the G groups of xf (G*T, d) over all E experts at capacity C
    and run the experts [e_off, e_off + len(ws[0])) of weights `ws`
    (w_gate, w_up, w_down): their partial y (G*T, d), each token's kept
    slots of those experts summed, and the balance loss of the routing."""
    E, K, d = cfg.n_experts, cfg.topk_experts, xf.shape[-1]
    e_loc = ws[0].shape[0]
    T = xf.shape[0] // G
    logits = (xf @ p["router"].to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                      # (G*T, E)
    r = route(probs.reshape(G, T, E), K, C)
    slot, order = r.slot, r.order
    valid = r.valid
    if e_loc < E:             # this position's experts only
        lo, n = e_off * G * C, e_loc * G * C
        slot = torch.where((slot >= lo) & (slot < lo + n), slot - lo, n)
        order = order[e_off:e_off + e_loc]
        valid = valid[e_off:e_off + e_loc]

    g = torch.arange(G, device=xf.device)[:, None] * T
    token = (order + g).reshape(e_loc, G * C)
    x_e = _Dispatch.apply(xf, token, slot)                     # (e, G*C, d)
    h = torch.nn.functional.silu(torch.bmm(x_e, ws[0].to(xf.dtype)))
    h = h * torch.bmm(x_e, ws[1].to(xf.dtype))
    out = torch.bmm(h, ws[2].to(xf.dtype))                     # (e, G*C, d)
    w_tok = torch.zeros_like(probs.reshape(G, T, E)).scatter(
        -1, r.top_i, r.top_p)
    w_slot = torch.gather(w_tok, 1, r.order.permute(1, 2, 0)) \
        .permute(2, 0, 1) * r.valid                            # (E, G, C)
    w_slot = w_slot[e_off:e_off + e_loc]
    out = out * w_slot.reshape(e_loc, G * C, 1).to(out.dtype)
    y = _Combine.apply(out.reshape(e_loc * G * C, d), slot, token, valid)

    f = torch.mean(torch.zeros_like(probs).scatter_(
        -1, r.top_i.reshape(G * T, K), 1.0), dim=0)
    aux = E * torch.sum(f * torch.mean(probs, dim=0))
    return y, aux


def moe_mesh(p, cfg: ArchConfig, lay, xs):
    """`moe` on a mesh (`tp.Layout`) with expert parallelism over 'model',
    as the reference's `ranked` (`src/repro/models/moe.py:102-156`): xs
    holds each position's normed (B_loc, S, d) input gathered to full S.
    A position routes its batch shard's B_loc*S tokens as one group over
    all E experts (capacity from those local tokens), runs its E/model
    experts from `e_offset = rank * E/model` (`tp.take`: the whole
    leaves sliced, or the 'model' block a process holds) with their
    'data' shards
    all-gathered over 'data', and combines the experts' partial outputs
    with a reduce-scatter along the sequence under sequence parallelism,
    else a psum; the balance loss is averaged over the batch axes. Without
    tensor parallelism (no 'model' axis, or `dp_only`) every position
    runs every expert on its shard. Returns (per position y, aux of
    position 0, or of the process's own position on a process mesh:
    every position holds the same).

    On a decode layout (`lay.decode`) each row is its own group of one
    token, as `moe(per_row=True)` routes it, no expert weight is gathered
    over 'data', the partial outputs are all-reduced over 'model', and
    the balance loss is neither reduced nor returned (None)."""
    mesh, reg = lay.mesh, lay.registry
    E = cfg.n_experts
    if E % lay.n_model:
        raise ValueError(f"{E} experts do not divide over 'model' "
                         f"{lay.n_model}")
    e_loc = E // lay.n_model
    B, S, d = mesh_mod.first(xs).shape
    G = B * S if lay.decode else 1
    C = _capacity(B * S // G, cfg, lay.rt.moe_capacity)
    ws = mesh_mod.pmap(lambda i, _: [tp.take(lay, i, p[n], 0, e_loc)
                                     for n in ("w_gate", "w_up", "w_down")],
                       xs)
    n_data = mesh.shape.get("data", 1)
    if (lay.n_model > 1 and n_data > 1 and d % n_data == 0
            and not lay.decode):
        # the experts' 'data' shards (d of w_gate and w_up, d of w_down)
        c = d // n_data
        for j, axis in enumerate((1, 1, 2)):
            got = mesh_mod.all_gather(
                mesh, mesh_mod.pmap(lambda i, w: w[j].narrow(
                    axis, mesh.coord(i, "data") * c, c), ws), "data",
                dim=axis, registry=reg)
            for w, g in zip(ws, got):
                if w is not None:
                    w[j] = g
    out = mesh_mod.pmap(lambda i, x, w: _experts(
        p, cfg, x.reshape(B * S, d), G, C, lay.rank(i) * e_loc, w), xs, ws)
    ys = mesh_mod.pmap(lambda _, o: o[0].reshape(B, S, d), out)
    auxes = mesh_mod.pmap(lambda _, o: o[1], out)
    if lay.n_model > 1:
        ys = (mesh_mod.reduce_scatter(mesh, ys, "model", dim=1, registry=reg)
              if lay.seq else mesh_mod.all_reduce(mesh, ys, "model", "sum",
                                                  registry=reg))
    if lay.decode:
        return ys, None
    axes = lay.rt.batch_axes
    if axes and mesh.group_size(axes) > 1:
        auxes = mesh_mod.all_reduce(mesh, auxes, axes, "sum", registry=reg)
        auxes = mesh_mod.pmap(lambda _, a: a / mesh.group_size(axes),
                              auxes)
    return ys, mesh_mod.first(auxes)
