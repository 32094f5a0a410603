"""Decoder model of the dense and moe families: embed -> layer stack ->
LM head, as a full-sequence forward (training / prefill) and as one-token
decode. A layer is attention then an MLP (dense) or a mixture of experts
(moe), each behind its RMS norm.

Parameters are a plain dict mirroring the reference's tree (layers stacked
on axis 0), so `models.convert.params_from_jax` is a one-to-one map and
every product takes the same operands as in the reference. The split-
learning cut is a residual-stream boundary: `apply_layers(..., lo, hi)`
runs any contiguous layer range, and `split.model.forward` composes
bottom range -> cut codec -> top range.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention, common, mlp, moe
from repro_torch.models.config import ArchConfig, Runtime

FAMILIES = ("dense", "moe")


def check_family(cfg: ArchConfig):
    """Raise for a family the port does not run yet."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r} is not ported yet "
                         f"(ported: {FAMILIES})")


def init_model(cfg: ArchConfig, generator: torch.Generator, device=None):
    """Random weights drawn from `generator` (on `device`)."""
    check_family(cfg)
    dt, L, d = cfg.pdtype(), cfg.n_layers, cfg.d_model

    def w(shape, scale=0.02):
        return common.normal_init(generator, shape, dt, scale, device=device)

    layers = {"attn": attention.init_attention(generator, cfg, L, device)}
    if cfg.family == "moe":
        layers["moe"] = moe.init_moe(generator, cfg, L, device)
    else:
        layers["mlp"] = mlp.init_mlp(generator, cfg, L, device)
    return {
        "embed": w((cfg.padded_vocab, d)),
        "final_norm": common.init_norm(d, dt, device),
        "unembed": w((d, cfg.padded_vocab)),
        "layers": layers,
    }


def layer_params(params, layer: int):
    """One layer's weights as views into the stacked tensors."""
    def pick(tree):
        return {k: pick(v) if isinstance(v, dict) else v[layer]
                for k, v in tree.items()}
    return pick(params["layers"])


def embed(params, cfg: ArchConfig, tokens):
    """tokens (B, S) -> (B, S, d) in the activation dtype."""
    return params["embed"][tokens.long()].to(cfg.adtype())


def lm_head(params, cfg: ArchConfig, x):
    x = common.rms_norm(x, params["final_norm"]["scale"])
    return x @ params["unembed"].to(x.dtype)


def _ffn(pl, cfg: ArchConfig, rt: Runtime, x, per_row: bool = False):
    """The layer's second half on the normed residual: (the MLP, None) or
    (the mixture of experts, its balance loss)."""
    if cfg.family == "moe":
        return moe.moe(pl["moe"], cfg, rt, common.rms_norm(
            x, pl["moe"]["norm"]["scale"]), per_row=per_row)
    return mlp.mlp(pl["mlp"], common.rms_norm(x, pl["mlp"]["norm"][
        "scale"])), None


def _layer_fwd(pl, cfg: ArchConfig, rt: Runtime, x):
    h = common.rms_norm(x, pl["attn"]["norm"]["scale"])
    x = x + attention.full_attention(pl["attn"], cfg, rt, h)
    y, aux = _ffn(pl, cfg, rt, x)
    return x + y, aux


def apply_layers(params, cfg: ArchConfig, rt: Runtime, x, extras, lo: int,
                 hi: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run layers [lo, hi) over x (B, S, d). Returns (x, aux loss): the
    moe family's balance losses summed over the layers, in layer order as
    the reference sums them (0 for dense). With `rt.remat` (and autograd
    on) each layer is recomputed in the backward instead of keeping its
    activations; nothing random runs inside a layer, so the recompute
    gives the forward's numbers."""
    check_family(cfg)
    remat = rt.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in range(lo, hi):
        pl = layer_params(params, layer)
        if remat:
            x, a = checkpoint(_layer_fwd, pl, cfg, rt, x, use_reentrant=False)
        else:
            x, a = _layer_fwd(pl, cfg, rt, x)
        if a is not None:
            aux = aux + a
    return x, aux


def make_extras(params, cfg: ArchConfig, rt: Runtime, batch) -> dict:
    """Family-specific side inputs from the batch dict (none for dense and
    moe)."""
    return {}


def forward(params, cfg: ArchConfig, rt: Runtime, batch):
    """Full forward (no split). Returns (logits (B, S, V), aux loss)."""
    extras = make_extras(params, cfg, rt, batch)
    x = embed(params, cfg, batch["tokens"])
    x, aux = apply_layers(params, cfg, rt, x, extras, 0, cfg.n_layers)
    return lm_head(params, cfg, x), aux


def cross_entropy(logits, labels):
    """Mean token cross-entropy, computed in f32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def init_cache(cfg: ArchConfig, rows: int, max_len: int, device=None):
    """Decode state for `rows` sessions: per-row positions and the KV cache
    of every layer (the client fills [0, cut), the server [cut, L))."""
    return {"pos": torch.zeros((rows,), dtype=torch.int64, device=device),
            "kv": attention.init_kv_cache(cfg, rows, cfg.n_layers, max_len,
                                          device)}


# decode routes each row alone: a capacity of 1 whatever the factor
DECODE_RT = Runtime(training=False)


def decode_layers(params, cfg: ArchConfig, x, cache: Dict[str, Any],
                  lo: int, hi: int, rows=None):
    """One-token pass of x (B, 1, d) through layers [lo, hi), each row at
    its own position `cache["pos"]`. Writes the KV of those layers in place
    for `rows` (None = all); the caller advances `pos`. Rows are
    independent: a moe layer routes each row as its own group (the
    reference vmaps one session at a time), so no row takes expert
    capacity from another."""
    pos = cache["pos"]
    k_all, v_all = cache["kv"]["k"], cache["kv"]["v"]
    for layer in range(lo, hi):
        pl = layer_params(params, layer)
        h = common.rms_norm(x, pl["attn"]["norm"]["scale"])
        x = x + attention.decode_attention(
            pl["attn"], cfg, h, k_all[:, layer, 0], v_all[:, layer, 0], pos,
            rows)
        x = x + _ffn(pl, cfg, DECODE_RT, x, per_row=True)[0]
    return x
