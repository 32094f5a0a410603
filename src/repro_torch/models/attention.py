"""GQA attention: full-sequence (training / prefill) self-attention, and
one-token decode against a rolling KV cache; with `cfg.qk_norm`, q and k
are RMS-normed over head_dim after the projection and before RoPE.

For decode, the reference vmaps one session at a time, each with its own
scalar position; here the sessions are a batch dimension written out, so
every use of the position (RoPE, the ring slot `pos % size`, the KV write
and the validity mask) takes a per-row `pos` vector. The decode cache is
16-bit (the activation dtype) or int8 codes with f32 per-(token, head)
scales (`init_kv_cache(bits=8)`, the label owner's arena at
`kv_cache_bits=8`).

Cross attention (the vlm's gated layers over image patches, the whisper
decoder's over the encoder output) has no RoPE and sees every key: q
comes from the residual, k and v from the tokens or from a `cross_kv`
cache computed once per session. A gated block scales its output by
`tanh(gate)`, a 0-d weight that starts at 0.

On a decode mesh (`decode_attention_mesh`, `cross_decode_mesh`) flash
decode splits a KV ring's slots, and a cross KV's tokens, over 'model'
and combines the partial softmaxes by all-reduces (`_flash_combine`).
"""
from __future__ import annotations

import torch

from repro_torch import mesh as mesh_mod
from repro_torch.models import common, tp
from repro_torch.models.config import ArchConfig, Runtime


def init_attention(generator, cfg: ArchConfig, n_layers: int, device=None,
                   *, gated=False):
    """Stacked (n_layers, ...) attention weights, the reference's layout
    (x @ W); `gated` adds the cross block's 0-d `gate` (zeros)."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt, L = cfg.pdtype(), n_layers

    def w(shape, scale=0.02):
        return common.normal_init(generator, (L,) + shape, dt, scale,
                                  device=device)

    p = {
        "norm": common.init_norm(d, dt, device, cfg.norm, (L,)),
        "wq": w((d, hq * hd)),
        "wk": w((d, hkv * hd)),
        "wv": w((d, hkv * hd)),
        "wo": w((hq * hd, d), 0.02 / max(1, cfg.n_layers) ** 0.5),
    }
    if cfg.qk_norm:
        p["q_norm"] = {"scale": torch.ones((L, hd), dtype=dt, device=device)}
        p["k_norm"] = {"scale": torch.ones((L, hd), dtype=dt, device=device)}
    if gated:
        p["gate"] = torch.zeros((L,), dtype=dt, device=device)
    return p


def attention_spec(cfg: ArchConfig, *, gated=False):
    """One layer's layouts (`common.norm_spec`), the reference's
    `attention_spec`: the projections over ('data', 'model')."""
    p = {
        "norm": common.norm_spec(cfg.norm),
        "wq": ("data", "model"),
        "wk": ("data", "model"),
        "wv": ("data", "model"),
        "wo": ("model", "data"),
    }
    if cfg.qk_norm:
        p["q_norm"] = {"scale": ()}
        p["k_norm"] = {"scale": ()}
    if gated:
        p["gate"] = ()
    return p


def attention_reads(cfg: ArchConfig, lay, *, gated=False, flash=False):
    """`attention_spec`'s leaves a position of `lay` (a `tp.Layout`) reads
    as exactly its 'model' block (`common.block_reads`). Where 'model'
    splits the q heads (`lay.split`): wo's rows (`tp.out_proj_rs`); in
    training wq's columns and, where 'model' divides the k/v heads
    (`_kv_blocks`), wk's and wv's (`_read_qkv`; else a position reads
    whole k/v heads); in decode wq's unless `flash` (the position attends
    with every head over its share of the ring's slots or the cross
    tokens: `_flash_out`, `cross_decode_mesh`), and never wk or wv (a
    decode position projects every k/v head, `_decode_qkv`, and the
    cross KV cache is built from every head)."""
    split = lay.split(cfg.n_heads)
    kv = split and not lay.decode and _kv_blocks(cfg, lay)
    return common.block_reads(attention_spec(cfg, gated=gated),
                              wq=split and not (lay.decode and flash),
                              wk=kv, wv=kv, wo=split)


def _kv_blocks(cfg: ArchConfig, lay) -> bool:
    """Whether 'model' divides the k/v heads, so that a position's q heads
    read exactly its 'model' block of them."""
    return cfg.n_kv_heads % lay.n_model == 0


def init_kv_cache(cfg: ArchConfig, rows: int, n_layers: int, max_len: int,
                  device=None, *, bits: int = 16):
    """Rolling cache of `n_layers` attention layers (or sites): k/v (rows,
    n_layers, 1, size, Hkv, hd), the reference's per-session (1, size, Hkv,
    hd) leaf stacked over layers and then over sessions. bits=16 stores
    them in the activation dtype; bits=8 stores int8 codes and f32
    per-(token, head) scales k_scale/v_scale (rows, n_layers, 1, size, Hkv)
    (symmetric quantization, dequantized on read)."""
    size = min(max_len, cfg.sliding_window) if cfg.sliding_window \
        else max_len
    shape = (rows, n_layers, 1, size, cfg.n_kv_heads, cfg.hd)
    if bits == 8:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:5], dtype=torch.float32,
                                       device=device),
                "v_scale": torch.zeros(shape[:5], dtype=torch.float32,
                                       device=device)}
    if bits != 16:
        raise ValueError(f"kv cache bits {bits}: 16 or 8")
    return {"k": torch.zeros(shape, dtype=cfg.adtype(), device=device),
            "v": torch.zeros(shape, dtype=cfg.adtype(), device=device)}


def quantize_kv(x):
    """x (B, 1, H, hd) -> (int8 codes, f32 scale (B, 1, H)): the scale is
    max |x| / 127 over hd, codes round half to even (as `jnp.round`) and
    clip to +-127; a zero row divides by the 1e-9 floor."""
    xf = x.float()
    scale = torch.amax(xf.abs(), dim=-1) / 127.0
    safe = torch.clamp_min(scale, 1e-9)
    code = torch.clamp(torch.round(xf / safe[..., None]), -127, 127)
    return code.to(torch.int8), scale


def dequantize_kv(code, scale, dtype):
    return (code.float() * scale[..., None]).to(dtype)


def sdpa(q, k, v, mask, cfg: ArchConfig):
    """q: (B,Sq,Hq,hd), k/v: (B,Skv,Hkv,hd), mask: (B,Sq,Skv) bool; the
    head counts are the tensors' (a mesh position attends with its local
    q heads and their k/v heads).

    Operands are upcast to f32 before each product, so bf16 inputs
    accumulate in f32 as the reference's `preferred_element_type` asks;
    the softmax weights are rounded to v's dtype first, as there."""
    hq, hkv, hd = q.shape[2], k.shape[2], cfg.hd
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


def _causal_mask(q_pos, kv_pos, window: int):
    """(Sq,) x (Skv,) -> (Sq, Skv) bool; window=0 means unbounded."""
    m = kv_pos[None, :] <= q_pos[:, None]
    if window:
        m &= kv_pos[None, :] > q_pos[:, None] - window
    return m


def project_q(p, cfg: ArchConfig, x, wq=None):
    """q (B, S, Hq, hd) of x (B, S, d), qk-normed, without RoPE; with `wq`
    (columns of p["wq"], a mesh position's `_read_qkv`) only the heads
    whose columns it holds."""
    B, S, _ = x.shape
    wq = p["wq"] if wq is None else wq
    q = (x @ wq.to(x.dtype)).reshape(B, S, -1, cfg.hd)
    if cfg.qk_norm:
        q = common.rms_norm(q, p["q_norm"]["scale"])
    return q


def cross_kv(p, cfg: ArchConfig, kv_tokens, w=None):
    """k, v (B, N, Hkv, hd) of kv_tokens (B, N, d), qk-normed, without
    RoPE: the cross-attention cache of the encoder's or the image's
    tokens; with `w` = (wk, wv) (columns of p["wk"] and p["wv"], a mesh
    position's `_read_qkv`) only the k and v heads whose columns they
    hold."""
    B, N, _ = kv_tokens.shape
    wk, wv = (p["wk"], p["wv"]) if w is None else w
    dt = kv_tokens.dtype
    k = (kv_tokens @ wk.to(dt)).reshape(B, N, -1, cfg.hd)
    v = (kv_tokens @ wv.to(dt)).reshape(B, N, -1, cfg.hd)
    if cfg.qk_norm:
        k = common.rms_norm(k, p["k_norm"]["scale"])
    return k, v


def project_qkv(p, cfg: ArchConfig, x, positions, w=None):
    """q (B, S, Hq, hd), k and v (B, S, Hkv, hd) of x (B, S, d) at
    `positions` (B or 1, S), qk-normed (`cfg.qk_norm`) and with RoPE
    applied to q and k (none when `positions` is None): exactly the
    operands `full_attention` attends with, and the decode's new token
    (the reference's `_project_qkv`). `w`: (wq, wk, wv) to project with
    (`project_q`, `cross_kv`), p's without it."""
    wq, *wkv = w or (None, None, None)
    q = project_q(p, cfg, x, wq)
    k, v = cross_kv(p, cfg, x, None if w is None else wkv)
    if positions is not None:
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def full_attention(p, cfg: ArchConfig, rt: Runtime, x, *, causal=True,
                   rope=True):
    """Training / prefill self-attention over x (B, S, d): causal with
    RoPE, or (the whisper encoder) bidirectional without it. Sequences
    longer than `rt.attn_chunk` (and a multiple of it) are attended one
    query chunk at a time, bounding the logits at (chunk, S)."""
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)
    q, k, v = project_qkv(p, cfg, x, pos[None] if rope else None)
    out = _attend(cfg, rt, q, k, v, causal)
    return out.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"].to(x.dtype)


def _attend(cfg: ArchConfig, rt: Runtime, q, k, v, causal: bool):
    """sdpa of q (B, S, h, hd) over the whole sequence's k, v, causal or
    not, in query chunks of `rt.attn_chunk` where S is longer and a
    multiple of it."""
    S = q.shape[1]
    pos = torch.arange(S, device=q.device)

    def mask_for(q_pos):
        if not causal:
            return torch.ones((1, q_pos.shape[0], S), dtype=torch.bool,
                              device=q.device)
        return _causal_mask(q_pos, pos, cfg.sliding_window)[None]

    c = rt.attn_chunk
    if S <= c or S % c != 0:
        return sdpa(q, k, v, mask_for(pos), cfg)
    return torch.cat([sdpa(q[:, i:i + c], k, v, mask_for(pos[i:i + c]),
                           cfg) for i in range(0, S, c)], dim=1)


def full_attention_mesh(p, cfg: ArchConfig, lay, xs, *, causal=True,
                        rope=True):
    """`full_attention` on a mesh (`tp.Layout`): xs holds each position's
    normed (B_loc, S, d) input, gathered to full S. With the heads split
    over 'model' (`lay.split(n_heads)`) a position projects and attends
    with its H/model q heads and the k and v heads its q heads read (the
    reference shards q over 'model' and keeps k and v whole,
    `src/repro/models/attention.py:100-102`), and `tp.out_proj_rs`
    reduce-scatters its partial output product along the sequence; else
    every position attends whole and keeps its chunk. `causal` and
    `rope` as in `full_attention` (whisper's encoder: neither). Returns
    per position (B_loc, S/model, d) (or (B_loc, S, d) without sequence
    parallelism)."""
    return _attention_mesh(p, cfg, lay, xs, None, causal=causal, rope=rope)


def cross_attention_mesh(p, cfg: ArchConfig, lay, xs, kv_tokens, *,
                         gated=False):
    """`cross_attention` on a mesh: xs as in `full_attention_mesh`,
    kv_tokens each position's (B_loc, N, d) image patches or encoder
    output, whole. The q heads split as in `full_attention_mesh`, each
    position projecting from its kv_tokens the k and v heads its q heads
    read; `tp.out_proj_rs` then reduce-scatters, and `gated` scales each
    position's chunk by tanh(p["gate"]) (the reference's
    `src/repro/models/attention.py:134-151`)."""
    ys = _attention_mesh(p, cfg, lay, xs, kv_tokens, causal=False,
                         rope=False)
    return _gate(p, ys) if gated else ys


def _gate(p, ys):
    return mesh_mod.pmap(lambda _, y: common.tanh_gate(p, y), ys)


def _attention_mesh(p, cfg: ArchConfig, lay, xs, kv_tokens, *, causal,
                    rope):
    split = lay.split(cfg.n_heads)
    kvs = kv_tokens or [None] * len(xs)
    return tp.out_proj_rs(
        lay, mesh_mod.pmap(lambda i, x, kv: _heads_out(
            p, cfg, lay.rt, x, _read_qkv(p, cfg, lay, i, split),
            kv_tokens=kv, causal=causal, rope=rope), xs, kvs), p["wo"],
        split=split)


def _read_qkv(p, cfg: ArchConfig, lay, i: int, split: bool):
    """What position `i` of `lay` reads of the projections: (h0, hl, its
    q heads [h0, h0 + hl) (every head without `split`), a, the first of
    the k/v heads [a, b) those read, wq's columns of its q heads, wk's
    and wv's of those k/v heads). wq's are the position's 'model' block
    (`tp.take`); so are wk's and wv's where 'model' divides the k/v heads,
    else (fewer k/v heads than 'model' positions: a position reads whole
    k/v heads, not a block) they are sliced from the whole leaves."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    hl = hq // lay.n_model if split else hq
    h0 = lay.rank(i) * hl if split else 0
    g = hq // hkv
    a, b = h0 // g, (h0 + hl - 1) // g + 1     # the k/v heads read
    wq = tp.take(lay, i, p["wq"], 1, hl * hd)
    if split and _kv_blocks(cfg, lay):
        wkv = tuple(tp.take(lay, i, p[n], 1, (b - a) * hd)
                    for n in ("wk", "wv"))
    else:
        wkv = tuple(tp.take(lay, i, p[n], 1, hkv * hd)[:, a * hd:b * hd]
                    for n in ("wk", "wv"))
    return h0, hl, a, wq, wkv


def _heads_out(p, cfg: ArchConfig, rt: Runtime, x, read, *, kv_tokens=None,
               causal=True, rope=True):
    """The attention output (B, S, hl * hd) of q heads [h0, h0 + hl) over
    x (B, S, d), before the output projection, with the k and v heads
    those q heads read (`read`: `_read_qkv`'s), projected from x (self
    attention: causal or not, with RoPE or not) or from `kv_tokens`
    (cross attention: every key visible, no RoPE)."""
    B, S, _ = x.shape
    h0, hl, a, wq, wkv = read
    q = project_q(p, cfg, x, wq)
    k, v = cross_kv(p, cfg, x if kv_tokens is None else kv_tokens, wkv)
    k, v = _kv_heads(cfg, k, v, h0, hl, first=a)
    if kv_tokens is not None:
        mask = torch.ones((1, S, k.shape[1]), dtype=torch.bool,
                          device=x.device)
        return sdpa(q, k, v, mask, cfg).reshape(B, S, hl * cfg.hd)
    if rope:
        pos = torch.arange(S, device=x.device)[None]
        q = common.apply_rope(q, pos, cfg.rope_theta)
        k = common.apply_rope(k, pos, cfg.rope_theta)
    return _attend(cfg, rt, q, k, v, causal).reshape(B, S, hl * cfg.hd)


def _kv_heads(cfg: ArchConfig, k, v, h0: int, hl: int, first: int = 0):
    """The k and v heads that q heads [h0, h0 + hl) read, of k and v
    (B, N, H, hd) whose head 0 is k/v head `first`: those heads' range,
    or, where the q heads hold part of a group, one k/v head per q
    head."""
    g = cfg.n_heads // cfg.n_kv_heads
    a, b = h0 // g, (h0 + hl - 1) // g + 1
    if hl % g:                # part of a group: each q head's k/v head
        idx = torch.arange(h0, h0 + hl, device=k.device) // g - first
        return k[:, :, idx], v[:, :, idx]
    return k[:, :, a - first:b - first], v[:, :, a - first:b - first]


def cross_attention(p, cfg: ArchConfig, x, kv_tokens=None, *, kv_cache=None,
                    gated=False):
    """Cross attention of x (B, S, d) over kv_tokens (B, N, d), or over a
    precomputed `kv_cache` (k, v) each (B, N, Hkv, hd): no RoPE, every key
    visible; `gated` scales the output by tanh(p["gate"])."""
    B, S, _ = x.shape
    q = project_q(p, cfg, x)
    k, v = kv_cache if kv_cache is not None else cross_kv(p, cfg, kv_tokens)
    mask = torch.ones((1, S, k.shape[1]), dtype=torch.bool, device=x.device)
    out = sdpa(q, k, v, mask, cfg)
    y = out.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"].to(x.dtype)
    return common.tanh_gate(p, y) if gated else y


def layer_kv(kv, layer: int):
    """One layer's (or site's) views of the stacked cache: every leaf
    without its layer and singleton axes, e.g. k (rows, size, Hkv, hd)."""
    return {name: t[:, layer, 0] for name, t in kv.items()}


def _store(kv, at, news, own=None):
    """Write each row's new k and v (`news`, each (n, Hkv, hd)) at the
    cache index `at`, quantized where the cache holds int8 codes (codes
    and scales); with `own` ((n,) bool) a row outside it writes back what
    `at` already holds."""
    for name, new in zip(("k", "v"), news):
        if "k_scale" in kv:
            code, scale = quantize_kv(new)
            leaves = ((name, code), (name + "_scale", scale))
        else:
            leaves = ((name, new),)
        for leaf, val in leaves:
            if own is not None:
                keep = own.reshape((-1,) + (1,) * (val.dim() - 1))
                val = torch.where(keep, val, kv[leaf][at])
            kv[leaf][at] = val


def _read(kv, dtype):
    """k, v of a cache's views, dequantized from int8 codes to `dtype`."""
    if "k_scale" in kv:
        return (dequantize_kv(kv["k"], kv["k_scale"], dtype),
                dequantize_kv(kv["v"], kv["v_scale"], dtype))
    return kv["k"], kv["v"]


def _valid(cfg: ArchConfig, pos, size: int, idx):
    """(B, n) bool: which ring slots `idx` ((n,) of a ring of `size`) hold
    a position the token at `pos` ((B,)) attends to: the absolute
    position each slot holds after the token's write at `pos % size`,
    at most `pos` and, with a sliding window, within it."""
    idx = idx[None, :]
    p_, s_ = pos[:, None], (pos % size)[:, None]
    abs_pos = idx + torch.where(idx <= s_, p_ - s_, p_ - size - s_)
    valid = (abs_pos >= 0) & (abs_pos <= p_)
    if cfg.sliding_window:
        valid &= abs_pos > p_ - cfg.sliding_window
    return valid


def decode_attention(p, cfg: ArchConfig, x_tok, kv, pos, rows=None):
    """x_tok: (B, 1, d); kv: one layer's cache views (`layer_kv`): k, v
    (B, size, Hkv, hd), and with an int8 cache k_scale, v_scale (B, size,
    Hkv); pos: (B,) absolute position of each row's new token.

    Writes the new K/V (int8 codes and scales when the cache holds
    `k_scale`) IN PLACE at each row's ring slot, only for `rows` (an index
    vector; None = every row), so inactive arena rows keep their cache
    (the reference's `where(active, new, old)`). Rows not written attend
    over their old cache; their outputs are discarded by the caller.
    Returns y (B, 1, d)."""
    B = x_tok.shape[0]
    hq, hd = cfg.n_heads, cfg.hd
    size = kv["k"].shape[1]
    q, k_new, v_new = project_qkv(p, cfg, x_tok, pos[:, None])
    slot = pos % size
    if rows is None:
        rows = torch.arange(B, device=pos.device)
    _store(kv, (rows, slot[rows]), (k_new[rows, 0], v_new[rows, 0]))
    k, v = _read(kv, x_tok.dtype)
    valid = _valid(cfg, pos, size, torch.arange(size, device=pos.device))
    out = sdpa(q, k, v, valid[:, None, :], cfg)
    return out.reshape(B, 1, hq * hd) @ p["wo"].to(x_tok.dtype)


def decode_ring(cfg: ArchConfig, lay, p: int, pos, size: int, slots: int):
    """Position `p`'s view of its decode rings for one step, the same
    for every layer: rows at `pos` ((B,)), rings of `size` slots of
    which the position holds `slots` (all of them, or with flash decode
    the 'model' rank's contiguous share). Holds `pos`, RoPE's tables at
    `pos` (`common.rope_tables`), the write index `at` of each row's
    slot `pos % size` among the position's slots, `own` (with flash
    decode: whether the position holds that slot; else None) and
    `valid` (B, slots), `decode_attention`'s validity rule on them."""
    lo = lay.rank(p) * slots if slots < size else 0
    slot = pos % size
    rows = torch.arange(pos.shape[0], device=pos.device)
    own = None
    if slots < size:
        own = (slot >= lo) & (slot < lo + slots)
        slot = (slot - lo).clamp(0, slots - 1)
    return {"pos": pos, "at": (rows, slot), "own": own,
            "rope": common.rope_tables(pos[:, None], cfg.hd, cfg.rope_theta,
                                       device=pos.device),
            "valid": _valid(cfg, pos, size,
                            lo + torch.arange(slots, device=pos.device))}


def decode_attention_mesh(p, cfg: ArchConfig, lay, xs, kvs, rings):
    """`decode_attention` on a decode mesh (`tp.Layout(decode=True)`): xs
    holds each position's normed (B_loc, 1, d) token, kvs each position's
    views of one layer's cache (`transformer.init_cache_mesh`), rings
    each position's `decode_ring`. Every row's new K and V go to its
    ring slot. Returns per position (B_loc, 1, d), equal over each
    'model' group.

      * 'model' of 1: each position runs `decode_attention` on its rows.
      * Flash decode (the position holds a share of the ring's slots,
        `tp.Layout.ring_split`): position r of a 'model' group of m
        holds slots [r * size / m, (r + 1) * size / m), and only the
        position holding a row's slot writes it. Each position projects
        q, k and v whole and attends with every head over its own slots
        under `decode_attention`'s validity rule. The partials combine
        by all-reduces over 'model' (`mesh.all_reduce`, f32): the max of
        the logits, then the sum of exp(logit - max), then the weights
        normalized by it and rounded to v's dtype (as `sdpa` rounds its
        softmax), times v, summed. Three small all-reduces (B_loc x Hq x
        (1 + 1 + hd) f32) carry what an all-gather of every position's
        (max, sum, output) would carry m times over.
      * Otherwise every position keeps the whole ring (the reference's
        replication) and writes every row.

    Either way wo's rows split by head over 'model' where 'model'
    divides the heads (`lay.split`), as in training, and the partial
    products close with `tp.sum_model`; without flash decode a position
    also projects and attends only its q heads (k and v are projected
    whole: its ring holds every head)."""
    if lay.n_model == 1:
        return mesh_mod.pmap(lambda _, x, kv, r: decode_attention(
            p, cfg, x, kv, r["pos"]), xs, kvs, rings)
    hq, hd = cfg.n_heads, cfg.hd
    split = lay.split(hq)
    hl = hq // lay.n_model if split else hq
    if mesh_mod.first(rings)["own"] is not None:     # flash decode
        hs = _own_heads(lay, _flash_out(p, cfg, lay, xs, kvs, rings), split,
                        hl * hd)
    else:
        hs = mesh_mod.pmap(lambda i, x, kv, r: _replicated_out(
            p, cfg, x, kv, r, lay.rank(i) * hl if split else 0, hl,
            _decode_qkv(p, cfg, lay, i, hl)), xs, kvs, rings)
    return tp.out_proj_rs(lay, hs, p["wo"], split=split)


def _decode_qkv(p, cfg: ArchConfig, lay, i: int, hl: int):
    """Position `i`'s (wq, wk, wv) in decode: wq's columns of its `hl` q
    heads at its 'model' rank (its block; every column where `hl` is
    every head) and the whole wk and wv (a decode position projects every
    k/v head: its ring, or its share of the ring's slots, holds every
    head), each read through `tp.take`."""
    hd = cfg.hd
    return (tp.take(lay, i, p["wq"], 1, hl * hd),
            *(tp.take(lay, i, p[n], 1, cfg.n_kv_heads * hd)
              for n in ("wk", "wv")))


def _own_heads(lay, outs, split: bool, width: int):
    """Each position's own q heads' columns, `width` of them at its
    'model' rank, of a whole attention output (all of it without
    `split`)."""
    return mesh_mod.pmap(lambda i, o: o[..., lay.rank(i) * width:
                                        (lay.rank(i) + 1) * width]
                         if split else o, outs)


def _flash_out(p, cfg: ArchConfig, lay, xs, kvs, rings):
    """Flash decode's attention output (B_loc, 1, Hq * hd) of every head,
    whole on each position (`decode_attention_mesh`)."""

    def local(i, x, kv, r):
        q, k_new, v_new = project_qkv(p, cfg, x, None, _decode_qkv(
            p, cfg, lay, i, cfg.n_heads))
        q, k_new = (common.rotate(t, *r["rope"]) for t in (q, k_new))
        _store(kv, r["at"], (k_new[:, 0], v_new[:, 0]), r["own"])
        return (q, *_read(kv, x.dtype), r["valid"])

    return _flash_combine(cfg, lay, *mesh_mod.unzip(
        mesh_mod.pmap(local, xs, kvs, rings), 4))


def _flash_combine(cfg: ArchConfig, lay, qs, ks, vs, valids=None):
    """Every head of each position's q (B_loc, 1, Hq, hd) over its share
    of the keys, k and v (B_loc, n, Hkv, hd), where `valids` ((B_loc, n)
    bool a position) says which it sees (all without them), combined over
    'model' into the whole attention output (B_loc, 1, Hq * hd) on every
    position: the f32 max of the logits, the sum of exp(logit - max), and
    the weights normalized by it and rounded to v's dtype (as `sdpa`
    rounds its softmax) times v, each by an all-reduce."""
    mesh, reg, pmap = lay.mesh, lay.registry, mesh_mod.pmap
    B, hq, hd = mesh_mod.first(qs).shape[0], cfg.n_heads, cfg.hd
    g = hq // cfg.n_kv_heads

    def logit(i, q, k):
        qg = q.reshape(B, 1, cfg.n_kv_heads, g, hd)
        lg = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) \
            / (hd ** 0.5)
        if valids is not None:
            lg = torch.where(valids[i][:, None, None, None, :], lg,
                             torch.full_like(lg, -1e30))
        return lg

    logits = pmap(logit, qs, ks)
    top = mesh_mod.all_reduce(
        mesh, pmap(lambda _, lg: lg.amax(dim=-1, keepdim=True), logits),
        "model", "max", registry=reg)
    es = pmap(lambda _, lg, m: torch.exp(lg - m), logits, top)
    tot = mesh_mod.all_reduce(
        mesh, pmap(lambda _, e: e.sum(dim=-1, keepdim=True), es), "model",
        "sum", registry=reg)
    parts = pmap(lambda _, e, s, v: torch.einsum(
        "bhgqk,bkhd->bqhgd", (e / s).to(v.dtype).float(), v.float()), es,
        tot, vs)
    outs = mesh_mod.all_reduce(mesh, parts, "model", "sum", registry=reg)
    return pmap(lambda _, o, q: o.reshape(B, 1, hq * hd).to(q.dtype), outs,
                qs)


def _replicated_out(p, cfg: ArchConfig, x, kv, ring, h0: int, hl: int, w):
    """The attention output (B, 1, hl * hd) of q heads [h0, h0 + hl) over
    a whole ring, the new token's k and v (every head) written first; `w`:
    the position's (wq, wk, wv), `_decode_qkv`'s."""
    B, hd = x.shape[0], cfg.hd
    q = common.rotate(project_q(p, cfg, x, w[0]), *ring["rope"])
    k_new, v_new = cross_kv(p, cfg, x, w[1:])
    k_new = common.rotate(k_new, *ring["rope"])
    _store(kv, ring["at"], (k_new[:, 0], v_new[:, 0]))
    k, v = _kv_heads(cfg, *_read(kv, x.dtype), h0, hl)
    return sdpa(q, k, v, ring["valid"][:, None, :], cfg).reshape(
        B, 1, hl * hd)


def cross_decode_mesh(p, cfg: ArchConfig, lay, xs, kvs, split_n: bool, *,
                      gated=False):
    """`cross_attention` of one token over a cross KV cache on a decode
    mesh (`tp.Layout(decode=True)`): xs holds each position's normed
    (B_loc, 1, d) token, whole over its 'model' group, kvs each
    position's (k, v) (B_loc, n, Hkv, hd) of the cache
    (`transformer.init_cache_mesh`), which the step reads and never
    writes. Returns per position (B_loc, 1, d), equal over each group.

      * `split_n`, the N tokens split over 'model' (`tp.Layout.
        ring_split(N)`, n = N / model): each position attends with every head over its share
        of the tokens, every one visible, and the partials combine as
        flash decode's (`_flash_combine`: three f32 all-reduces).
      * Otherwise every position holds all N tokens and attends its q
        heads over them, with the k and v heads those read
        (`_kv_heads`).

    Either way wo's rows split by head over 'model' where 'model'
    divides the heads, closed with `tp.sum_model` (`tp.out_proj_rs`),
    and `gated` (the vlm) scales the result by tanh(p["gate"])."""
    hq, hd = cfg.n_heads, cfg.hd
    split = lay.split(hq)
    hl = hq // lay.n_model if split else hq
    if split_n:
        k, v = mesh_mod.unzip(kvs, 2)
        hs = _own_heads(lay, _flash_combine(cfg, lay, mesh_mod.pmap(
            lambda i, x: project_q(p, cfg, x, tp.take(lay, i, p["wq"], 1,
                                                      hq * hd)), xs), k, v),
            split, hl * hd)
    else:
        def local(i, x, kv):
            h0 = lay.rank(i) * hl if split else 0
            q = project_q(p, cfg, x, tp.take(lay, i, p["wq"], 1, hl * hd))
            k, v = _kv_heads(cfg, *kv, h0, hl)
            mask = torch.ones((1, 1, k.shape[1]), dtype=torch.bool,
                              device=x.device)
            return sdpa(q, k, v, mask, cfg).reshape(x.shape[0], 1, hl * hd)

        hs = mesh_mod.pmap(local, xs, kvs)
    ys = tp.out_proj_rs(lay, hs, p["wo"], split=split)
    return _gate(p, ys) if gated else ys
