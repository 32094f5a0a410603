"""SwiGLU MLP block, optionally gated (the vlm's cross layers), and its
tensor-parallel form on a mesh (`mlp_mesh`)."""
from __future__ import annotations

import torch

from repro_torch import mesh as mesh_mod
from repro_torch.models import common, tp
from repro_torch.models.config import ArchConfig


def init_mlp(generator, cfg: ArchConfig, n_layers: int, device=None, *,
             gated=False):
    """Stacked (n_layers, ...) SwiGLU weights, the reference's layout;
    `gated` adds the 0-d `gate` (zeros)."""
    d, ff, dt, L = cfg.d_model, cfg.d_ff, cfg.pdtype(), n_layers

    def w(shape, scale=0.02):
        return common.normal_init(generator, (L,) + shape, dt, scale,
                                  device=device)

    p = {
        "norm": common.init_norm(d, dt, device, cfg.norm, (L,)),
        "w_gate": w((d, ff)),
        "w_up": w((d, ff)),
        "w_down": w((ff, d), 0.02 / max(1, cfg.n_layers) ** 0.5),
    }
    if gated:
        p["gate"] = torch.zeros((L,), dtype=dt, device=device)
    return p


def mlp_spec(cfg: ArchConfig, *, gated=False):
    """One layer's layouts (`common.norm_spec`), the reference's
    `mlp_spec`."""
    p = {
        "norm": common.norm_spec(cfg.norm),
        "w_gate": ("data", "model"),
        "w_up": ("data", "model"),
        "w_down": ("model", "data"),
    }
    if gated:
        p["gate"] = ()
    return p


def mlp_reads(cfg: ArchConfig, lay, *, gated=False):
    """`mlp_spec`'s leaves a position of `lay` reads as exactly its
    'model' block (`common.block_reads`): w_gate's and w_up's columns and
    w_down's rows where 'model' splits d_ff (`mlp_mesh`)."""
    split = lay.split(cfg.d_ff)
    return common.block_reads(mlp_spec(cfg, gated=gated), w_gate=split,
                              w_up=split, w_down=split)


def mlp(p, x, *, gated=False):
    """silu(x Wg) * (x Wu) Wd — the reference's `tp.out_proj_rs` without a
    mesh is the plain `h @ w_down`; `gated` scales it by tanh(p["gate"])."""
    h = torch.nn.functional.silu(x @ p["w_gate"].to(x.dtype)) \
        * (x @ p["w_up"].to(x.dtype))
    y = h @ p["w_down"].to(h.dtype)
    return common.tanh_gate(p, y) if gated else y


def mlp_mesh(p, cfg: ArchConfig, lay, xs, *, gated=False):
    """`mlp` on a mesh (`tp.Layout`), xs each position's normed (B_loc, S,
    d) input gathered to full S: with ff split over 'model'
    (`lay.split(d_ff)`) a position takes its ff/model columns of w_gate
    and w_up and `tp.out_proj_rs` reduce-scatters its partial w_down
    product (its rows) along the sequence (`src/repro/models/mlp.py:40-47`;
    on a decode layout it sums them over 'model'), each read through
    `tp.take` (the whole leaf sliced, or the 'model' block a process
    holds); else every position computes the MLP whole and keeps its
    chunk. `gated`
    (the vlm's cross MLP) scales each position's chunk by the scalar
    tanh(p["gate"])."""
    split = lay.split(cfg.d_ff)
    n = cfg.d_ff // lay.n_model if split else cfg.d_ff

    def hidden(i, x):
        wg, wu = (tp.take(lay, i, p[k], 1, n) for k in ("w_gate", "w_up"))
        return torch.nn.functional.silu(x @ wg.to(x.dtype)) \
            * (x @ wu.to(x.dtype))

    ys = tp.out_proj_rs(lay, mesh_mod.pmap(hidden, xs), p["w_down"],
                        split=split)
    return mesh_mod.pmap(lambda _, y: common.tanh_gate(p, y), ys) if gated \
        else ys
