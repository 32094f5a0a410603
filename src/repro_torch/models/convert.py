"""Carry the reference's parameters into the port.

`params_from_jax(np_params, cfg, device)` takes the reference's parameter
tree with numpy leaves (`jax.tree.map(np.asarray, params)` on the caller's
side) and returns the port's dict of tensors. The layout stays the
reference's (x @ W, layers stacked on axis 0), so the two packages multiply
the same operands:

    embed (padded_vocab, d), final_norm.scale (d,), unembed (d, padded_vocab)
    (every norm also carries .bias (..., d) where cfg.norm is "layer")
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
    layers.{attn, mlp}   (L - L/g, ...), vlm: the self layers
    cross_layers.attn.{norm.scale, wq, wk, wv, wo, gate (L/g,)},
    cross_layers.mlp.{norm.scale, w_gate, w_up, w_down, gate (L/g,)},
        vlm: the gated cross layers (g = cross_attn_every)
    enc_layers.{attn, mlp}   (n_enc_layers, ...), enc_norm.{scale, bias},
    layers.{attn, cross, mlp}   (L, ...), audio (whisper)

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
    """The reference's tree of any family (numpy leaves) -> port weights
    in `cfg.param_dtype` on `device`."""
    transformer.check_family(cfg)
    dt = cfg.pdtype()

    def norm(src):
        return {k: _tensor(src[k], dt, device) for k in
                (("scale", "bias") if "bias" in src else ("scale",))}

    def block(src, keys):
        keys = keys + (("gate",) if "gate" in src else ())
        return {k: (norm(src[k]) if k in _NORMS
                    else _tensor(src[k], dt, device)) for k in keys}

    def attn_mlp(src, qk=()):
        return {"attn": block(src["attn"], _KEYS["attn"] + qk),
                "mlp": block(src["mlp"], _KEYS["mlp"])}

    out = {
        "embed": _tensor(np_params["embed"], dt, device),
        "final_norm": norm(np_params["final_norm"]),
        "unembed": _tensor(np_params["unembed"], dt, device),
    }
    src = np_params["layers"]
    qk = ("q_norm", "k_norm") if cfg.qk_norm else ()
    if cfg.family == "vlm":
        out["layers"] = attn_mlp(src, qk)
        out["cross_layers"] = attn_mlp(np_params["cross_layers"], qk)
    elif cfg.family == "audio":
        out["enc_layers"] = attn_mlp(np_params["enc_layers"], qk)
        out["enc_norm"] = norm(np_params["enc_norm"])
        out["layers"] = dict(attn_mlp(src, qk), cross=block(
            src["cross"], _KEYS["attn"] + qk))
    elif cfg.family == "hybrid":
        out["layers"] = block(src, _KEYS["mamba"])
        out["shared_attn"] = block(np_params["shared_attn"], _KEYS["attn"])
        out["shared_mlp"] = block(np_params["shared_mlp"], _KEYS["mlp"])
    elif cfg.family == "ssm":
        out["layers"] = {part: block(src[part], _KEYS[part])
                         for part in ("time", "chan")}
    else:
        ffn = "moe" if cfg.family == "moe" else "mlp"
        out["layers"] = {"attn": block(src["attn"], _KEYS["attn"] + qk),
                         ffn: block(src[ffn], _KEYS[ffn])}
    return out


def parties_from_jax(np_bottom, np_top, device) -> tuple:
    """The reference's tabular `(bottom, top)` dicts (numpy leaves) -> the
    port's, f32 on `device`."""
    def conv(part):
        return {k: _tensor(v, torch.float32, device) for k, v in part.items()}

    return conv(np_bottom), conv(np_top)
