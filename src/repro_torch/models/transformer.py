"""Decoder model of the dense, moe, hybrid and ssm families: embed ->
layer stack -> LM head, as a full-sequence forward (training / prefill)
and as one-token decode. Each block sits behind its RMS norm:

  * dense / moe: attention, then an MLP or a mixture of experts;
  * hybrid (zamba2): a Mamba2 mixer (`models.ssm`); after every
    `attn_every`-th layer one SHARED attention + MLP block (`shared_attn`,
    `shared_mlp`, one set of weights for every site) with its own KV
    cache per site;
  * ssm (rwkv6): RWKV6 time-mix, then channel-mix (`models.rwkv`).

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

from repro_torch.models import attention, common, mlp, moe, rwkv, ssm
from repro_torch.models.config import ArchConfig, Runtime

FAMILIES = ("dense", "moe", "hybrid", "ssm")


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

    params = {
        "embed": w((cfg.padded_vocab, d)),
        "final_norm": common.init_norm(d, dt, device),
        "unembed": w((d, cfg.padded_vocab)),
    }
    if cfg.family == "hybrid":
        params["layers"] = ssm.init_mamba(generator, cfg, L, device)
        params["shared_attn"] = _unstack(attention.init_attention(
            generator, cfg, 1, device))
        params["shared_mlp"] = _unstack(mlp.init_mlp(generator, cfg, 1,
                                                     device))
    elif cfg.family == "ssm":
        params["layers"] = {
            "time": rwkv.init_rwkv_time(generator, cfg, L, device),
            "chan": rwkv.init_rwkv_channel(generator, cfg, L, device)}
    else:
        layers = {"attn": attention.init_attention(generator, cfg, L,
                                                   device)}
        if cfg.family == "moe":
            layers["moe"] = moe.init_moe(generator, cfg, L, device)
        else:
            layers["mlp"] = mlp.init_mlp(generator, cfg, L, device)
        params["layers"] = layers
    return params


def _unstack(tree):
    """A stack of one layer -> that layer's weights."""
    return {k: _unstack(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


def layer_params(params, layer: int):
    """One layer's weights as views into the stacked tensors."""
    def pick(tree):
        return {k: pick(v) if isinstance(v, dict) else v[layer]
                for k, v in tree.items()}
    return pick(params["layers"])


def attn_sites(cfg: ArchConfig):
    """Hybrid: for each layer, the index of the shared-attention site that
    follows it (its KV cache), or -1 where none does."""
    out, s = [], 0
    for i in range(cfg.n_layers):
        if cfg.attn_every and (i + 1) % cfg.attn_every == 0:
            out.append(s)
            s += 1
        else:
            out.append(-1)
    return out


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


def _shared_block(params, cfg: ArchConfig, rt: Runtime, x):
    """Hybrid: the shared attention + MLP block, full sequence."""
    sa, sm = params["shared_attn"], params["shared_mlp"]
    h = x + attention.full_attention(sa, cfg, rt, common.rms_norm(
        x, sa["norm"]["scale"]))
    return h + mlp.mlp(sm, common.rms_norm(h, sm["norm"]["scale"]))


def _layer_fwd(params, layer: int, cfg: ArchConfig, rt: Runtime, x):
    """Layer `layer` over x (B, S, d): (x, its moe balance loss or None)."""
    pl = layer_params(params, layer)
    if cfg.family == "hybrid":
        x = x + ssm.mamba(pl, cfg, rt, common.rms_norm(
            x, pl["norm"]["scale"]))
        if attn_sites(cfg)[layer] >= 0:
            x = _shared_block(params, cfg, rt, x)
        return x, None
    if cfg.family == "ssm":
        pt, pc = pl["time"], pl["chan"]
        x = x + rwkv.rwkv_time_mix(pt, cfg, rt, common.rms_norm(
            x, pt["norm"]["scale"]))[0]
        return x + rwkv.rwkv_channel_mix(pc, common.rms_norm(
            x, pc["norm"]["scale"])), None
    h = common.rms_norm(x, pl["attn"]["norm"]["scale"])
    x = x + attention.full_attention(pl["attn"], cfg, rt, h)
    y, aux = _ffn(pl, cfg, rt, x)
    return x + y, aux


def apply_layers(params, cfg: ArchConfig, rt: Runtime, x, extras, lo: int,
                 hi: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run layers [lo, hi) over x (B, S, d). Returns (x, aux loss): the
    moe family's balance losses summed over the layers, in layer order as
    the reference sums them (0 for the other families). With `rt.remat`
    (and autograd on) each layer, a hybrid layer's shared block included,
    is recomputed in the backward instead of keeping its activations;
    nothing random runs inside a layer, so the recompute gives the
    forward's numbers."""
    check_family(cfg)
    remat = rt.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in range(lo, hi):
        if remat:
            x, a = checkpoint(_layer_fwd, params, layer, cfg, rt, x,
                              use_reentrant=False)
        else:
            x, a = _layer_fwd(params, layer, cfg, rt, x)
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


def init_cache(cfg: ArchConfig, rows: int, max_len: int, device=None,
               bits: int = 16):
    """Decode state for `rows` sessions: per-row positions and every
    layer's state (the client fills [0, cut), the server [cut, L)):

      * dense / moe: `kv` of every layer;
      * hybrid: `mamba` {h, conv} of every layer and `kv` of every
        shared-attention site (`attn_sites`);
      * ssm: `rwkv` {S, x_tm, x_cm} of every layer.

    `bits` is the KV cache's width: 16 (the activation dtype) or 8 (int8
    codes and f32 scales, the label owner's arena at `kv_cache_bits=8`)."""
    check_family(cfg)
    L = cfg.n_layers
    cache: Dict[str, Any] = {
        "pos": torch.zeros((rows,), dtype=torch.int64, device=device)}
    if cfg.family == "ssm":
        cache["rwkv"] = rwkv.init_rwkv_cache(cfg, rows, L, device)
        return cache
    n_kv = L
    if cfg.family == "hybrid":
        cache["mamba"] = ssm.init_mamba_cache(cfg, rows, L, device)
        n_kv = sum(s >= 0 for s in attn_sites(cfg))
    cache["kv"] = attention.init_kv_cache(cfg, rows, n_kv, max_len, device,
                                          bits=bits)
    return cache


# decode routes each row alone: a capacity of 1 whatever the factor
DECODE_RT = Runtime(training=False)


def _write_rows(dst, layer: int, new, rows):
    """dst[rows, layer] = new[rows]: a layer's new recurrent state is kept
    for the written rows only, so an inactive arena row does not
    advance."""
    if rows is None:
        dst[:, layer] = new
    else:
        dst[rows, layer] = new[rows]


def decode_layers(params, cfg: ArchConfig, x, cache: Dict[str, Any],
                  lo: int, hi: int, rows=None):
    """One-token pass of x (B, 1, d) through layers [lo, hi), each row at
    its own position `cache["pos"]`. Writes those layers' state in place
    (KV, and the recurrent families' state and conv or token-shift
    history) for `rows` (None = all); the caller advances `pos`. Rows are
    independent: a moe layer routes each row as its own group (the
    reference vmaps one session at a time), so no row takes expert
    capacity from another. A hybrid range without a shared-attention site
    runs its Mamba2 layers alone."""
    pos = cache["pos"]
    sites = attn_sites(cfg) if cfg.family == "hybrid" else None
    for layer in range(lo, hi):
        pl = layer_params(params, layer)
        if cfg.family == "ssm":
            st = cache["rwkv"]
            x, S, x_tm, x_cm = rwkv.rwkv_decode(
                pl["time"], pl["chan"], x, st["S"][:, layer],
                st["x_tm"][:, layer], st["x_cm"][:, layer])
            for name, new in (("S", S), ("x_tm", x_tm), ("x_cm", x_cm)):
                _write_rows(st[name], layer, new, rows)
            continue
        if cfg.family == "hybrid":
            mc = cache["mamba"]
            y, h, conv = ssm.mamba_decode(
                pl, cfg, common.rms_norm(x, pl["norm"]["scale"]),
                mc["h"][:, layer], mc["conv"][:, layer])
            _write_rows(mc["h"], layer, h, rows)
            _write_rows(mc["conv"], layer, conv, rows)
            x = x + y
            if sites[layer] >= 0:
                sa, sm = params["shared_attn"], params["shared_mlp"]
                x = x + attention.decode_attention(
                    sa, cfg, common.rms_norm(x, sa["norm"]["scale"]),
                    attention.layer_kv(cache["kv"], sites[layer]), pos,
                    rows)
                x = x + mlp.mlp(sm, common.rms_norm(x, sm["norm"]["scale"]))
            continue
        h = common.rms_norm(x, pl["attn"]["norm"]["scale"])
        x = x + attention.decode_attention(
            pl["attn"], cfg, h, attention.layer_kv(cache["kv"], layer), pos,
            rows)
        x = x + _ffn(pl, cfg, DECODE_RT, x, per_row=True)[0]
    return x
