"""Carry the reference's parameters into the port.

`params_from_jax(np_params, cfg, device)` takes the reference's parameter
tree with numpy leaves (`jax.tree.map(np.asarray, params)` on the caller's
side) and returns the port's dict of tensors. The layout stays the
reference's (x @ W, layers stacked on axis 0), so the two packages multiply
the same operands:

    embed (padded_vocab, d), final_norm.scale (d,), unembed (d, padded_vocab)
    layers.attn.{norm.scale, wq, wk, wv, wo}   (L, ...)
    layers.attn.{q_norm.scale, k_norm.scale}   (L, hd), with cfg.qk_norm
    layers.mlp.{norm.scale, w_gate, w_up, w_down}   (L, ...), dense
    layers.moe.{norm.scale (L, d), router (L, d, E),
                w_gate, w_up (L, E, d, ff), w_down (L, E, ff, d)}, moe

`parties_from_jax(np_bottom, np_top, device)` does the same for the
tabular trainer's two parties (`split.tabular`): flat dicts of f32
matrices and biases, `x @ w + b` in both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig

_KEYS = {
    "attn": ("norm", "wq", "wk", "wv", "wo"),
    "mlp": ("norm", "w_gate", "w_up", "w_down"),
    "moe": ("norm", "router", "w_gate", "w_up", "w_down"),
}
_NORMS = ("norm", "q_norm", "k_norm")


def _tensor(a, dtype, device) -> torch.Tensor:
    arr = np.array(a)                       # writable, contiguous copy
    if arr.dtype.name == "bfloat16":       # ml_dtypes bf16: carry the bits
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype)


def params_from_jax(np_params, cfg: ArchConfig, device) -> dict:
    """The reference's dense- or moe-family tree (numpy leaves) -> port
    weights in `cfg.param_dtype` on `device`."""
    transformer.check_family(cfg)
    dt = cfg.pdtype()

    def conv(a):
        return _tensor(a, dt, device)

    ffn = "moe" if cfg.family == "moe" else "mlp"
    qk = ("q_norm", "k_norm") if cfg.qk_norm else ()
    blocks = {"attn": _KEYS["attn"] + qk, ffn: _KEYS[ffn]}
    layers = {}
    for block, keys in blocks.items():
        src = np_params["layers"][block]
        layers[block] = {k: ({"scale": conv(src[k]["scale"])} if k in _NORMS
                             else conv(src[k])) for k in keys}
    return {
        "embed": conv(np_params["embed"]),
        "final_norm": {"scale": conv(np_params["final_norm"]["scale"])},
        "unembed": conv(np_params["unembed"]),
        "layers": layers,
    }


def parties_from_jax(np_bottom, np_top, device) -> tuple:
    """The reference's tabular `(bottom, top)` dicts (numpy leaves) -> the
    port's, f32 on `device`."""
    def conv(part):
        return {k: _tensor(v, torch.float32, device) for k, v in part.items()}

    return conv(np_bottom), conv(np_top)
