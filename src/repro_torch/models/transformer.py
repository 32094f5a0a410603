"""Dense decoder model: embed -> layer stack -> LM head, one-token decode.

Parameters are a plain dict mirroring the reference's tree (layers stacked
on axis 0), so `models.convert.params_from_jax` is a one-to-one map and
every product takes the same operands as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import attention, common, mlp
from repro_torch.models.config import ArchConfig


def init_model(cfg: ArchConfig, generator: torch.Generator, device=None):
    """Random weights drawn from `generator` (on `device`)."""
    if cfg.family != "dense":
        raise ValueError(f"family {cfg.family!r} is not ported yet")
    dt, L, d = cfg.pdtype(), cfg.n_layers, cfg.d_model

    def w(shape, scale=0.02):
        return common.normal_init(generator, shape, dt, scale, device=device)

    return {
        "embed": w((cfg.padded_vocab, d)),
        "final_norm": common.init_norm(d, dt, device),
        "unembed": w((d, cfg.padded_vocab)),
        "layers": {
            "attn": attention.init_attention(generator, cfg, L, device),
            "mlp": mlp.init_mlp(generator, cfg, L, device),
        },
    }


def layer_params(params, layer: int):
    """One layer's weights as views into the stacked tensors."""
    def pick(tree):
        return {k: pick(v) if isinstance(v, dict) else v[layer]
                for k, v in tree.items()}
    return pick(params["layers"])


def embed(params, cfg: ArchConfig, tokens):
    """tokens (B, 1) -> (B, 1, d) in the activation dtype."""
    return params["embed"][tokens.long()].to(cfg.adtype())


def lm_head(params, cfg: ArchConfig, x):
    x = common.rms_norm(x, params["final_norm"]["scale"])
    return x @ params["unembed"].to(x.dtype)


def init_cache(cfg: ArchConfig, rows: int, max_len: int, device=None):
    """Decode state for `rows` sessions: per-row positions and the KV cache
    of every layer (the client fills [0, cut), the server [cut, L))."""
    return {"pos": torch.zeros((rows,), dtype=torch.int64, device=device),
            "kv": attention.init_kv_cache(cfg, rows, cfg.n_layers, max_len,
                                          device)}


def decode_layers(params, cfg: ArchConfig, x, cache: Dict[str, Any],
                  lo: int, hi: int, rows=None):
    """One-token pass of x (B, 1, d) through layers [lo, hi), each row at
    its own position `cache["pos"]`. Writes the KV of those layers in place
    for `rows` (None = all); the caller advances `pos`."""
    pos = cache["pos"]
    k_all, v_all = cache["kv"]["k"], cache["kv"]["v"]
    for layer in range(lo, hi):
        pl = layer_params(params, layer)
        h = common.rms_norm(x, pl["attn"]["norm"]["scale"])
        x = x + attention.decode_attention(
            pl["attn"], cfg, h, k_all[:, layer, 0], v_all[:, layer, 0], pos,
            rows)
        x = x + mlp.mlp(pl["mlp"], common.rms_norm(x, pl["mlp"]["norm"][
            "scale"]))
    return x
