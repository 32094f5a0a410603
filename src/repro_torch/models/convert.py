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
    layers.{norm.scale, w_xz, w_bc, w_dt, conv_x, conv_b, conv_c, A_log, D,
            dt_bias, norm_g.scale, w_out}   (L, ...), hybrid (Mamba2)
    shared_attn.{norm.scale, wq, wk, wv, wo},
    shared_mlp.{norm.scale, w_gate, w_up, w_down}   (one block), hybrid
    layers.time.{norm.scale, mu, w_r, w_k, w_v, w_g, w0, w1, w2, u,
                 ln_x.scale, w_out}   (L, ...), ssm (RWKV6)
    layers.chan.{norm.scale, mu, w_k, w_v, w_r}   (L, ...), ssm

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
    "mamba": ("norm", "w_xz", "w_bc", "w_dt", "conv_x", "conv_b", "conv_c",
              "A_log", "D", "dt_bias", "norm_g", "w_out"),
    "time": ("norm", "mu", "w_r", "w_k", "w_v", "w_g", "w0", "w1", "w2",
             "u", "ln_x", "w_out"),
    "chan": ("norm", "mu", "w_k", "w_v", "w_r"),
}
_NORMS = ("norm", "q_norm", "k_norm", "norm_g", "ln_x")


def _tensor(a, dtype, device) -> torch.Tensor:
    arr = np.array(a)                       # writable, contiguous copy
    if arr.dtype.name == "bfloat16":       # ml_dtypes bf16: carry the bits
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype)


def params_from_jax(np_params, cfg: ArchConfig, device) -> dict:
    """The reference's dense-, moe-, hybrid- or ssm-family tree (numpy
    leaves) -> port weights in `cfg.param_dtype` on `device`."""
    transformer.check_family(cfg)
    dt = cfg.pdtype()

    def block(src, keys):
        return {k: ({"scale": _tensor(src[k]["scale"], dt, device)}
                    if k in _NORMS else _tensor(src[k], dt, device))
                for k in keys}

    out = {
        "embed": _tensor(np_params["embed"], dt, device),
        "final_norm": {"scale": _tensor(np_params["final_norm"]["scale"],
                                        dt, device)},
        "unembed": _tensor(np_params["unembed"], dt, device),
    }
    src = np_params["layers"]
    if cfg.family == "hybrid":
        out["layers"] = block(src, _KEYS["mamba"])
        out["shared_attn"] = block(np_params["shared_attn"], _KEYS["attn"])
        out["shared_mlp"] = block(np_params["shared_mlp"], _KEYS["mlp"])
    elif cfg.family == "ssm":
        out["layers"] = {part: block(src[part], _KEYS[part])
                         for part in ("time", "chan")}
    else:
        ffn = "moe" if cfg.family == "moe" else "mlp"
        qk = ("q_norm", "k_norm") if cfg.qk_norm else ()
        out["layers"] = {"attn": block(src["attn"], _KEYS["attn"] + qk),
                         ffn: block(src[ffn], _KEYS[ffn])}
    return out


def parties_from_jax(np_bottom, np_top, device) -> tuple:
    """The reference's tabular `(bottom, top)` dicts (numpy leaves) -> the
    port's, f32 on `device`."""
    def conv(part):
        return {k: _tensor(v, torch.float32, device) for k, v in part.items()}

    return conv(np_bottom), conv(np_top)
