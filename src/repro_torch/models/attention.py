"""GQA attention for one-token decode against a rolling KV cache.

The reference vmaps one session at a time, each with its own scalar
position; here the sessions are a batch dimension written out, so every
use of the position (RoPE, the ring slot `pos % size`, the KV write and the
validity mask) takes a per-row `pos` vector.
"""
from __future__ import annotations

import torch

from repro_torch.models import common
from repro_torch.models.config import ArchConfig


def init_attention(generator, cfg: ArchConfig, n_layers: int, device=None):
    """Stacked (n_layers, ...) attention weights, the reference's layout
    (x @ W)."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt, L = cfg.pdtype(), n_layers

    def w(shape, scale=0.02):
        return common.normal_init(generator, (L,) + shape, dt, scale,
                                  device=device)

    return {
        "norm": {"scale": torch.ones((L, d), dtype=dt, device=device)},
        "wq": w((d, hq * hd)),
        "wk": w((d, hkv * hd)),
        "wv": w((d, hkv * hd)),
        "wo": w((hq * hd, d), 0.02 / max(1, cfg.n_layers) ** 0.5),
    }


def init_kv_cache(cfg: ArchConfig, rows: int, n_layers: int, max_len: int,
                  device=None):
    """16-bit rolling cache: k/v (rows, n_layers, 1, size, Hkv, hd) in the
    activation dtype (the reference's per-session (1, size, Hkv, hd) leaf,
    stacked over layers and then over sessions)."""
    size = min(max_len, cfg.sliding_window) if cfg.sliding_window \
        else max_len
    shape = (rows, n_layers, 1, size, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.adtype(), device=device),
            "v": torch.zeros(shape, dtype=cfg.adtype(), device=device)}


def sdpa(q, k, v, mask, cfg: ArchConfig):
    """q: (B,Sq,Hq,hd), k/v: (B,Skv,Hkv,hd), mask: (B,Sq,Skv) bool.

    Operands are upcast to f32 before each product, so bf16 inputs
    accumulate in f32 as the reference's `preferred_element_type` asks;
    the softmax weights are rounded to v's dtype first, as there."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = hq // hkv
    B, Sq = q.shape[0], q.shape[1]
    qg = q.reshape(B, Sq, hkv, g, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) \
        / (hd ** 0.5)
    logits = torch.where(mask[:, None, None, :, :], logits,
                         torch.full_like(logits, -1e30))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype).float(), v.float())
    return out.reshape(B, Sq, hq, hd).to(q.dtype)


def decode_attention(p, cfg: ArchConfig, x_tok, k_cache, v_cache, pos,
                     rows=None):
    """x_tok: (B, 1, d); k_cache/v_cache: (B, size, Hkv, hd) views of one
    layer's cache; pos: (B,) absolute position of each row's new token.

    Writes the new K/V IN PLACE at each row's ring slot — only for `rows`
    (an index vector; None = every row), so inactive arena rows keep their
    cache (the reference's `where(active, new, old)`). Rows not written
    attend over their old cache; their outputs are discarded by the caller.
    Returns y (B, 1, d)."""
    B = x_tok.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    size = k_cache.shape[1]
    q = (x_tok @ p["wq"].to(x_tok.dtype)).reshape(B, 1, hq, hd)
    k_new = (x_tok @ p["wk"].to(x_tok.dtype)).reshape(B, 1, hkv, hd)
    v_new = (x_tok @ p["wv"].to(x_tok.dtype)).reshape(B, 1, hkv, hd)
    q = common.apply_rope(q, pos[:, None], cfg.rope_theta)
    k_new = common.apply_rope(k_new, pos[:, None], cfg.rope_theta)
    slot = pos % size
    if rows is None:
        rows = torch.arange(B, device=pos.device)
    k_cache[rows, slot[rows]] = k_new[rows, 0]
    v_cache[rows, slot[rows]] = v_new[rows, 0]

    # valid slots: the absolute position each ring slot holds
    idx = torch.arange(size, device=pos.device)[None, :]
    p_, s_ = pos[:, None], slot[:, None]
    abs_pos = idx + torch.where(idx <= s_, p_ - s_, p_ - size - s_)
    valid = (abs_pos >= 0) & (abs_pos <= p_)
    if cfg.sliding_window:
        valid &= abs_pos > p_ - cfg.sliding_window
    out = sdpa(q, k_cache, v_cache, valid[:, None, :], cfg)
    return out.reshape(B, 1, hq * hd) @ p["wo"].to(x_tok.dtype)
