"""Mamba2 block (SSD, structured state-space duality), chunked scan form.

Training / prefill runs the chunked SSD algorithm: within a chunk of
length c the contribution is a masked quadratic form, across chunks a
sequential loop carries the (B, H, P, N) f32 state. Every decay factor is
exp(non-positive), so nothing overflows. Decode is the exact one-step
recurrence with a depthwise-conv history of the last K - 1 inputs.

Single group (G = 1): head dim P = cfg.ssm_head_dim, state N =
cfg.ssm_state, inner width = ssm_expand * d_model. Weights are the
reference's tree, stacked over the layers.

The reference writes the chunk's products as einsums of up to five
operands and leaves their order to XLA. Here each is a chain of
two-operand products in a fixed order that never builds a (B, t, s, H, P)
tensor: C.B is contracted to (B, t, s) first, weighted by the decay and
dt to (B, t, s, H), and the chunk ends on a batched (t, s) x (s, P)
product per (batch, head).

On a training mesh (`mamba_mesh`, `models.tp.Layout`) the heads split
over 'model' as the reference shards the inner width
(`src/repro/models/ssm.py:113`): a position runs the SSD loop over its
heads' channels, the gated RMS norm sums its squares over the group
(`tp.sum_model`), and the output projection reduce-scatters
(`tp.out_proj_rs`). On a decode mesh (`mamba_decode_mesh`) a position
keeps the state `h` of its heads only, as the reference's `cache_spec`
lays it over 'model', and steps them the same way, `w_out`'s partial
products summed over the group.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import mesh as mesh_mod
from repro_torch.models import common, tp
from repro_torch.models.config import ArchConfig, Runtime


def init_mamba(generator, cfg: ArchConfig, n_layers: int, device=None):
    """Stacked (n_layers, ...) Mamba2 weights; A_log, D and dt_bias start at
    the reference's constants (A = -1, D = 1, softplus(-2) ~ 0.13)."""
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    K, dt, L = cfg.ssm_conv, cfg.pdtype(), n_layers

    def w(shape, scale=0.02):
        return common.normal_init(generator, (L,) + shape, dt, scale,
                                  device=device)

    def const(shape, value):
        return torch.full((L,) + shape, value, dtype=dt, device=device)

    return {
        "norm": {"scale": const((d,), 1.0)},
        "w_xz": w((d, 2 * di)),
        "w_bc": w((d, 2 * N)),
        "w_dt": w((d, H)),
        "conv_x": w((K, di), 0.1),
        "conv_b": w((K, N), 0.1),
        "conv_c": w((K, N), 0.1),
        "A_log": const((H,), 0.0),
        "D": const((H,), 1.0),
        "dt_bias": const((H,), -2.0),
        "norm_g": {"scale": const((di,), 1.0)},
        "w_out": w((di, d), 0.02 / max(1, cfg.n_layers) ** 0.5),
    }


def mamba_spec(cfg: ArchConfig):
    """One layer's layouts (`common.norm_spec`), the reference's
    `mamba_spec`."""
    return {
        "norm": common.norm_spec(cfg.norm),
        "w_xz": ("data", "model"),
        "w_bc": ("data", None),
        "w_dt": ("data", None),
        "conv_x": (None, "model"),
        "conv_b": (None, None),
        "conv_c": (None, None),
        "A_log": (None,),
        "D": (None,),
        "dt_bias": (None,),
        "norm_g": {"scale": ("model",)},
        "w_out": ("model", "data"),
    }


def mamba_reads(cfg: ArchConfig, lay):
    """`mamba_spec`'s leaves a position of `lay` reads as exactly its
    'model' block (`common.block_reads`) where 'model' splits the heads
    (`mamba_mesh`, `mamba_decode_mesh`): its heads' columns of conv_x
    (`_read_conv`), channels of norm_g (`_read_norm`) and rows of w_out.
    w_xz stays whole: a position reads its heads' x columns and their z
    columns, two strips (`project`)."""
    split = lay.split(cfg.ssm_heads)
    return common.block_reads(mamba_spec(cfg), conv_x=split, norm_g=split,
                              w_out=split)


def softplus(x):
    """log(1 + exp(x)) as `jax.nn.softplus` computes it (logaddexp(x, 0))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def causal_conv(u, w):
    """Depthwise causal conv in u's dtype, then SiLU. u: (B, S, C);
    w: (K, C). Tap i reads u shifted right by K - 1 - i."""
    K, S = w.shape[0], u.shape[1]
    acc = None
    for i in range(K):
        shift = K - 1 - i
        ui = F.pad(u, (0, 0, shift, 0))[:, :S] if shift else u
        term = ui * w[i].to(u.dtype)
        acc = term if acc is None else acc + term
    return F.silu(acc)


def project(p, cfg: ArchConfig, x, heads=None):
    """x (B, S, d) -> xs (B, S, di), z (B, S, di), b, c (B, S, N) in x's
    dtype and dt (B, S, H) f32; with `heads` = (h0, hl) xs, z and dt of
    heads [h0, h0 + hl) only (di -> hl * P, H -> hl), from their columns
    of `w_xz` and `w_dt`."""
    di, N = cfg.d_inner, cfg.ssm_state
    if heads is None:
        xz = x @ p["w_xz"].to(x.dtype)
        xs, z = xz[..., :di], xz[..., di:]
        dt_raw, bias = x @ p["w_dt"].to(x.dtype), p["dt_bias"]
    else:
        c, h = _channels(cfg, heads), slice(heads[0], sum(heads))
        w = p["w_xz"].to(x.dtype)
        xs = x @ w[:, c]
        z = x @ w[:, di + c.start:di + c.stop]
        dt_raw, bias = x @ p["w_dt"][:, h].to(x.dtype), p["dt_bias"][h]
    bc = x @ p["w_bc"].to(x.dtype)
    b, c = bc[..., :N], bc[..., N:]
    dt = softplus(dt_raw.float() + bias.float())
    return xs, z, b, c, dt


def _channels(cfg: ArchConfig, heads):
    """The inner-width channels of heads (h0, hl)."""
    P = cfg.ssm_head_dim
    return slice(heads[0] * P, (heads[0] + heads[1]) * P)


def ssd_chunk(h, xs, b, cm, dt, la):
    """One SSD chunk. h: (B, H, P, N) f32 carry; xs (B, c, H, P), b and cm
    (B, c, N), dt and la (B, c, H), all f32 (la: log decay per step,
    <= 0). Returns (h', y (B, c, H, P))."""
    c = la.shape[1]
    L = torch.cumsum(la, dim=1)                            # (B, c, H) <= 0
    tot = L[:, -1]                                         # (B, H)
    # state contribution: y1[t] = exp(L_t) * (C_t . h)
    y1 = torch.einsum("bcn,bhpn->bchp", cm, h) * torch.exp(L)[..., None]
    # intra-chunk: decay(t, s) = exp(L_t - L_s) for s <= t
    dec = torch.exp(L[:, :, None, :] - L[:, None, :, :])   # (B, t, s, H)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=la.device))
    dec = torch.where(mask[None, :, :, None], dec, torch.zeros_like(dec))
    cb = torch.einsum("btn,bsn->bts", cm, b)               # (B, t, s)
    wts = cb[..., None] * dec * dt[:, None, :, :]          # (B, t, s, H)
    y2 = torch.einsum("btsh,bshp->bthp", wts, xs)
    # new state: h' = exp(tot) h + sum_s exp(tot - L_s) dt_s x_s B_s^T
    carry = torch.exp(tot[:, None, :] - L) * dt            # (B, c, H)
    h_new = torch.exp(tot)[:, :, None, None] * h + torch.einsum(
        "bshp,bsn->bhpn", xs * carry[..., None], b)
    return h_new, y1 + y2


def _check_conv(heads, conv_x):
    if heads is not None and conv_x is None:
        raise ValueError("a subset of heads reads conv_x through conv_x= "
                         "(`_read_conv`)")


def _gated(p, cfg: ArchConfig, rt: Runtime, x, heads=None, conv_x=None):
    """The SSD mixer over the normed x (B, S, d) for heads (h0, hl) (all
    without `heads`): y * silu(z) (B, S, hl * P) in x's dtype, the gated
    norm's input. `conv_x`: the heads' columns of p["conv_x"] (a mesh
    position's, `_read_conv`), the only route for a subset of heads;
    without it p["conv_x"] is read whole."""
    _check_conv(heads, conv_x)
    B, S, _ = x.shape
    N, Pd = cfg.ssm_state, cfg.ssm_head_dim
    h0, H = heads or (0, cfg.ssm_heads)
    xs, z, b, cm, dt = project(p, cfg, x, heads)
    xs = causal_conv(xs, p["conv_x"] if conv_x is None else conv_x)
    b = causal_conv(b, p["conv_b"])
    cm = causal_conv(cm, p["conv_c"])

    A = -torch.exp(p["A_log"][h0:h0 + H].float())          # (H,)
    la = dt * A                                            # (B, S, H)
    xs4 = xs.reshape(B, S, H, Pd).float()
    bf, cf = b.float(), cm.float()

    cl = min(rt.ssm_chunk, S)
    if S % cl:
        raise ValueError(f"seq {S} must divide ssm_chunk {cl}")
    h = torch.zeros((B, H, Pd, N), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(0, S, cl):
        sl = slice(i, i + cl)
        h, y = ssd_chunk(h, xs4[:, sl], bf[:, sl], cf[:, sl], dt[:, sl],
                         la[:, sl])
        ys.append(y)
    y = torch.cat(ys, dim=1)
    y = y + p["D"][h0:h0 + H].float()[None, None, :, None] * xs4
    return y.reshape(B, S, H * Pd).to(x.dtype) * F.silu(z)


def mamba(p, cfg: ArchConfig, rt: Runtime, x):
    """Full-sequence Mamba2 mixer over the normed x (B, S, d) -> (B, S, d)."""
    y = common.rms_norm(_gated(p, cfg, rt, x), p["norm_g"]["scale"])
    return y @ p["w_out"].to(y.dtype)


def mamba_mesh(p, cfg: ArchConfig, lay, xs):
    """`mamba` on a mesh (`tp.Layout`), xs each position's normed (B_loc,
    S, d) input gathered to full S. With the heads split over 'model'
    (`lay.split(ssm_heads)`) a position runs its H/model heads: their
    columns of `w_xz` (xs and z) and `w_dt`, their slices of `conv_x`,
    `dt_bias`, `A_log`, `D` and `norm_g`; `w_bc` and the b/c convolutions
    are per token and run whole. The gated RMS norm's mean square is the
    group's f32 sum of squares (`tp.sum_model`, (B_loc, S, 1) a position)
    over d_inner, and `tp.out_proj_rs` reduce-scatters the partial
    `w_out` product along the sequence. Else every position runs the
    mixer whole and keeps its chunk."""
    rt, scale = lay.rt, p["norm_g"]["scale"]
    if not lay.split(cfg.ssm_heads):
        return tp.out_proj_rs(
            lay, mesh_mod.pmap(lambda _, x: common.rms_norm(
                _gated(p, cfg, rt, x), scale), xs), p["w_out"], split=False)
    heads = _heads(cfg, lay, xs)
    gs = mesh_mod.pmap(lambda i, x, h: _gated(
        p, cfg, rt, x, h, _read_conv(p, cfg, lay, i, h[1])), xs, heads)
    return tp.out_proj_rs(lay, _split_norm(p, cfg, lay, gs, heads),
                          p["w_out"], split=True)


def _heads(cfg: ArchConfig, lay, xs):
    """Each position's heads (h0, hl) of the Mamba2 heads split over
    'model'."""
    hl = cfg.ssm_heads // lay.n_model
    return mesh_mod.pmap(lambda i, _: (lay.rank(i) * hl, hl), xs)


def _read_conv(p, cfg: ArchConfig, lay, i: int, hl: int):
    """Position `i`'s columns of `conv_x` for its `hl` heads at its 'model'
    rank, through `tp.take`."""
    return tp.take(lay, i, p["conv_x"], 1, hl * cfg.ssm_head_dim)


def _read_norm(p, cfg: ArchConfig, lay, i: int, hl: int):
    """Position `i`'s channels of `norm_g` for its `hl` heads, through
    `tp.take`."""
    return tp.take(lay, i, p["norm_g"]["scale"], 0, hl * cfg.ssm_head_dim)


def _split_norm(p, cfg: ArchConfig, lay, gs, heads):
    """The gated RMS norm of each position's heads' channels gs (B_loc,
    S, hl * P): the mean square over the whole d_inner from the group's
    f32 sum of squares (`tp.sum_model`, (B_loc, S, 1) a position), then
    the heads' channels of `norm_g` (`_read_norm`)."""
    ssq = tp.sum_model(lay, mesh_mod.pmap(lambda _, g: torch.sum(
        torch.square(g.float()), dim=-1, keepdim=True), gs))
    return mesh_mod.pmap(
        lambda i, g, s, h: (g.float() * torch.rsqrt(s / cfg.d_inner + 1e-6)
                            * _read_norm(p, cfg, lay, i, h[1]).float())
        .to(g.dtype), gs, ssq, heads)


def init_mamba_cache(cfg: ArchConfig, rows: int, n_layers: int,
                     device=None, heads: int = None):
    """Decode state of `rows` sessions: h (rows, L, H, P, N) f32 and the
    conv history (rows, L, K - 1, di + 2N) in the activation dtype (the
    reference's per-session leaves without their batch axis of 1). With
    `heads` = hl (a decode mesh position's share, `mamba_decode_mesh`)
    h holds hl heads and the history the hl * P x channels those heads
    convolve, then the per-token b and c columns, whole."""
    N, Pd, K = cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_conv
    H = cfg.ssm_heads if heads is None else heads
    return {
        "h": torch.zeros((rows, n_layers, H, Pd, N), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((rows, n_layers, K - 1, H * Pd + 2 * N),
                            dtype=cfg.adtype(), device=device),
    }


def _decode_gated(p, cfg: ArchConfig, x_tok, h, conv, heads=None,
                  conv_x=None):
    """The one-step recurrence of heads (h0, hl) (all without `heads`)
    against their state h (B, hl, P, N) and conv history (B, K - 1,
    hl * P + 2N). Returns (y * silu(z) (B, 1, hl * P) in x_tok's dtype,
    the gated norm's input; h'; conv'). `conv_x` as in `_gated`."""
    _check_conv(heads, conv_x)
    B = x_tok.shape[0]
    N, Pd = cfg.ssm_state, cfg.ssm_head_dim
    h0, H = heads or (0, cfg.ssm_heads)
    di = H * Pd
    xs, z, b, cm, dt = project(p, cfg, x_tok, heads)
    u = torch.cat([xs, b, cm], dim=-1)                     # (B, 1, di+2N)
    hist = torch.cat([conv, u], dim=1)                     # (B, K, di+2N)
    w = torch.cat([p["conv_x"] if conv_x is None else conv_x,
                   p["conv_b"], p["conv_c"]], dim=-1)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", hist.float(), w.float()))
    xs1, b1, c1 = conv_out[:, :di], conv_out[:, di:di + N], \
        conv_out[:, di + N:]
    new_conv = hist[:, 1:].to(conv.dtype)

    A = -torch.exp(p["A_log"][h0:h0 + H].float())
    dt1 = dt[:, 0]                                         # (B, H)
    a = torch.exp(dt1 * A)                                 # (B, H)
    xh = xs1.reshape(B, H, Pd)
    h_new = h * a[:, :, None, None] + (dt1[:, :, None] * xh)[..., None] \
        * b1[:, None, None, :]
    y = torch.einsum("bn,bhpn->bhp", c1, h_new)
    y = y + p["D"][h0:h0 + H].float()[None, :, None] * xh
    y = y.reshape(B, 1, di).to(x_tok.dtype)
    return y * F.silu(z), h_new, new_conv


def mamba_decode(p, cfg: ArchConfig, x_tok, h, conv):
    """One-step recurrence of x_tok (B, 1, d) (normed) against one layer's
    state h (B, H, P, N) and conv (B, K - 1, di + 2N). Returns (y (B, 1, d),
    h', conv'); the caller writes the new state."""
    g, h_new, new_conv = _decode_gated(p, cfg, x_tok, h, conv)
    y = common.rms_norm(g, p["norm_g"]["scale"])
    return y @ p["w_out"].to(x_tok.dtype), h_new, new_conv


def mamba_decode_mesh(p, cfg: ArchConfig, lay, xs, hs, convs):
    """`mamba_decode` on a decode mesh (`tp.Layout(decode=True)`): xs
    holds each position's normed (B_loc, 1, d) token, whole over its
    'model' group, hs and convs its state of one layer. With the heads
    split over 'model' (`lay.split(ssm_heads)`) position r of a group of
    m steps heads [r * H / m, (r + 1) * H / m): their columns of `w_xz`
    and `w_dt`, their x columns of the conv history (`init_mamba_cache(
    heads=)`; `w_bc` and the b and c columns are per token and run
    whole), `A_log`, `D`; the gated norm's sum of squares over d_inner is
    the group's (`tp.sum_model` of (B_loc, 1, 1) f32) and `w_out`'s
    partial products are summed (`tp.out_proj_rs`). Else every position
    runs `mamba_decode` whole on whole state. Returns (each position's
    y (B_loc, 1, d), h', conv')."""
    if not lay.split(cfg.ssm_heads):
        return mesh_mod.unzip(mesh_mod.pmap(
            lambda _, x, h, c: mamba_decode(p, cfg, x, h, c), xs, hs,
            convs), 3)
    heads = _heads(cfg, lay, xs)
    gs, h_new, c_new = mesh_mod.unzip(mesh_mod.pmap(
        lambda i, x, h, c, hd: _decode_gated(
            p, cfg, x, h, c, hd, _read_conv(p, cfg, lay, i, hd[1])), xs, hs,
        convs, heads), 3)
    ys = tp.out_proj_rs(lay, _split_norm(p, cfg, lay, gs, heads),
                        p["w_out"], split=True)
    return ys, h_new, c_new
