"""SwiGLU MLP block."""
from __future__ import annotations

import torch

from repro_torch.models import common
from repro_torch.models.config import ArchConfig


def init_mlp(generator, cfg: ArchConfig, n_layers: int, device=None):
    """Stacked (n_layers, ...) SwiGLU weights, the reference's layout."""
    d, ff, dt, L = cfg.d_model, cfg.d_ff, cfg.pdtype(), n_layers

    def w(shape, scale=0.02):
        return common.normal_init(generator, (L,) + shape, dt, scale,
                                  device=device)

    return {
        "norm": {"scale": torch.ones((L, d), dtype=dt, device=device)},
        "w_gate": w((d, ff)),
        "w_up": w((d, ff)),
        "w_down": w((ff, d), 0.02 / max(1, cfg.n_layers) ** 0.5),
    }


def mlp(p, x):
    """silu(x Wg) * (x Wu) Wd — the reference's `tp.out_proj_rs` without a
    mesh is the plain `h @ w_down`."""
    h = torch.nn.functional.silu(x @ p["w_gate"].to(x.dtype)) \
        * (x @ p["w_up"].to(x.dtype))
    return h @ p["w_down"].to(h.dtype)
