"""Carry the reference's parameters into the port.

`params_from_jax(np_params, cfg, device)` takes the reference's parameter
tree with numpy leaves (`jax.tree.map(np.asarray, params)` on the caller's
side) and returns the port's dict of tensors. The layout stays the
reference's (x @ W, layers stacked on axis 0), so the two packages multiply
the same operands:

    embed (padded_vocab, d), final_norm.scale (d,), unembed (d, padded_vocab)
    layers.attn.{norm.scale, wq, wk, wv, wo}   (L, ...)
    layers.mlp.{norm.scale, w_gate, w_up, w_down}   (L, ...)
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ArchConfig

_KEYS = {
    "attn": ("norm", "wq", "wk", "wv", "wo"),
    "mlp": ("norm", "w_gate", "w_up", "w_down"),
}


def _tensor(a, dtype, device) -> torch.Tensor:
    arr = np.array(a)                       # writable, contiguous copy
    if arr.dtype.name == "bfloat16":       # ml_dtypes bf16: carry the bits
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype)


def params_from_jax(np_params, cfg: ArchConfig, device) -> dict:
    """The reference's dense-family tree (numpy leaves) -> port weights in
    `cfg.param_dtype` on `device`."""
    if cfg.family != "dense":
        raise ValueError(f"family {cfg.family!r} is not ported yet")
    dt = cfg.pdtype()

    def conv(a):
        return _tensor(a, dt, device)

    layers = {}
    for block, keys in _KEYS.items():
        src = np_params["layers"][block]
        layers[block] = {k: ({"scale": conv(src[k]["scale"])} if k == "norm"
                             else conv(src[k])) for k in keys}
    return {
        "embed": conv(np_params["embed"]),
        "final_norm": {"scale": conv(np_params["final_norm"]["scale"])},
        "unembed": conv(np_params["unembed"]),
        "layers": layers,
    }
