"""RWKV6 ("Finch") block: linear attention with a data-dependent
per-channel decay (time-mix), and a token-shifted squared-ReLU FFN
(channel-mix).

Time-mix evaluates the WKV6 recurrence chunk by chunk: `rt.rwkv_mode`
"chunk" (the default) takes each chunk in matrix form, "scan" steps
through it one token at a time (the exact recurrence, the numerics
oracle). Decode is the one-step recurrence. Heads are 64 wide, so a
layer has d // 64 of them whatever `cfg.n_heads` says, as in the
reference. r, k and v stay in the activation dtype; the decay chain and
every WKV product run in f32.

On a training mesh (`models.tp.Layout`) the time mix splits its heads
over 'model' and reduce-scatters `w_out` (`rwkv_time_mix_mesh`, the
reference's `src/repro/models/rwkv.py:199-201`), and the channel mix
splits `w_k`'s columns by d_ff and reduce-scatters `w_v` (`:210-213`,
`rwkv_channel_mix_mesh`). On a decode mesh (`rwkv_decode_mesh`) a
position keeps the state `S` of its heads only, as the reference's
`cache_spec` lays it over 'model', and both mixes close with a sum over
the group.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import mesh as mesh_mod
from repro_torch.models import common, tp
from repro_torch.models.config import ArchConfig, Runtime

HD = 64                                 # the WKV head width
PROJ = ("w_r", "w_k", "w_v", "w_g")     # the time mix's head projections


def init_rwkv_time(generator, cfg: ArchConfig, n_layers: int, device=None):
    """Stacked (n_layers, ...) time-mix weights (w0 at the reference's
    -0.7)."""
    d, lora, dt, L = cfg.d_model, cfg.rwkv_lora, cfg.pdtype(), n_layers

    def w(shape, scale=0.02):
        return common.normal_init(generator, (L,) + shape, dt, scale,
                                  device=device)

    def const(shape, value):
        return torch.full((L,) + shape, value, dtype=dt, device=device)

    return {
        "norm": {"scale": const((d,), 1.0)},
        "mu": w((5, d), 0.2),                  # r, k, v, g, w mixes
        "w_r": w((d, d)), "w_k": w((d, d)), "w_v": w((d, d)),
        "w_g": w((d, d)),
        "w0": const((d,), -0.7),
        "w1": w((d, lora)), "w2": w((lora, d)),
        "u": w((d // HD, HD), 0.5),
        "ln_x": {"scale": const((d,), 1.0)},
        "w_out": w((d, d), 0.02 / max(1, cfg.n_layers) ** 0.5),
    }


def rwkv_time_spec(cfg: ArchConfig):
    """One layer's time-mix layouts (`common.norm_spec`), the reference's
    `rwkv_time_spec`."""
    return {
        "norm": common.norm_spec(cfg.norm),
        "mu": (None, None),
        "w_r": ("data", "model"),
        "w_k": ("data", "model"),
        "w_v": ("data", "model"),
        "w_g": ("data", "model"),
        "w0": (None,), "w1": ("data", None), "w2": (None, None),
        "u": (None, None),
        "ln_x": {"scale": (None,)},
        "w_out": ("model", "data"),
    }


def rwkv_time_reads(cfg: ArchConfig, lay):
    """`rwkv_time_spec`'s leaves a position of `lay` reads as exactly its
    'model' block (`common.block_reads`) where 'model' splits the heads
    (`rwkv_time_mix_mesh`, `rwkv_decode_mesh`): its heads' columns of the
    `PROJ` projections (`_read_proj`) and rows of w_out."""
    split = lay.split(cfg.d_model // HD)
    return common.block_reads(rwkv_time_spec(cfg), w_out=split,
                              **dict.fromkeys(PROJ, split))


def init_rwkv_channel(generator, cfg: ArchConfig, n_layers: int,
                      device=None):
    """Stacked (n_layers, ...) channel-mix weights."""
    d, ff, dt, L = cfg.d_model, cfg.d_ff, cfg.pdtype(), n_layers

    def w(shape, scale=0.02):
        return common.normal_init(generator, (L,) + shape, dt, scale,
                                  device=device)

    return {
        "norm": {"scale": torch.ones((L, d), dtype=dt, device=device)},
        "mu": w((2, d), 0.2),                  # k, r mixes
        "w_k": w((d, ff)),
        "w_v": w((ff, d), 0.02 / max(1, cfg.n_layers) ** 0.5),
        "w_r": w((d, d)),
    }


def rwkv_channel_spec(cfg: ArchConfig):
    """One layer's channel-mix layouts (`common.norm_spec`), the
    reference's `rwkv_channel_spec`."""
    return {
        "norm": common.norm_spec(cfg.norm),
        "mu": (None, None),
        "w_k": ("data", "model"),
        "w_v": ("model", "data"),
        "w_r": ("data", None),
    }


def rwkv_channel_reads(cfg: ArchConfig, lay):
    """`rwkv_channel_spec`'s leaves a position of `lay` reads as exactly
    its 'model' block (`common.block_reads`): w_k's columns and w_v's rows
    where 'model' splits d_ff (`rwkv_channel_mix_mesh`)."""
    split = lay.split(cfg.d_ff)
    return common.block_reads(rwkv_channel_spec(cfg), w_k=split, w_v=split)


def token_shift(x, x_prev=None):
    """x (B, S, d) shifted right by one token; the first slot is x_prev
    (B, d), or zeros without one."""
    if x.shape[1] == 1 and x_prev is not None:
        return x_prev[:, None, :]
    shifted = F.pad(x, (0, 0, 1, 0))[:, :-1]
    if x_prev is not None:
        shifted = torch.cat([x_prev[:, None, :], shifted[:, 1:]], dim=1)
    return shifted


def time_mix_inputs(p, x, x_prev=None, heads=None, ws=None):
    """r, k, v (B, S, H, 64) and g (B, S, H * 64) in x's dtype, and the
    decay w (B, S, H, 64) in f32, of the heads (h0, H) (every head without
    `heads`): the token shift and the mixing LoRA's first matrix run
    whole, the projections and the decay's second matrix take the heads'
    columns. `ws`: the heads' columns of the `PROJ` projections by name,
    as a mesh position reads them (`_read_proj`), the only route for a
    subset of heads; without it p's are read whole."""
    B, S, d = x.shape
    if heads is not None and ws is None:
        raise ValueError("a subset of heads reads its projections through "
                         "ws (`_read_proj`)")
    h0, H = heads or (0, d // HD)
    c = slice(h0 * HD, (h0 + H) * HD)
    xp = token_shift(x, x_prev)
    mu = p["mu"].to(x.dtype)
    mix = [x + mu[i] * (xp - x) for i in range(5)]

    def proj(i, name):
        return mix[i] @ (p[name] if ws is None else ws[name]).to(x.dtype)

    r = proj(0, "w_r").reshape(B, S, H, HD)
    k = proj(1, "w_k").reshape(B, S, H, HD)
    v = proj(2, "w_v").reshape(B, S, H, HD)
    g = proj(3, "w_g")
    ww = p["w0"][c].float() + torch.tanh(mix[4].float() @ p["w1"].float()) \
        @ p["w2"][:, c].float()
    w = torch.exp(-torch.exp(ww)).reshape(B, S, H, HD)
    return r, k, v, g, w


def wkv_step(S, r, k, v, w, u):
    """The exact recurrence for one token. S: (B, H, K, V) f32; r, k, v, w:
    (B, H, 64); u: (H, 64) f32. Returns (S', out (B, H, V))."""
    r, k, v, w = r.float(), k.float(), v.float(), w.float()
    kv = k[..., :, None] * v[..., None, :]                 # (B, H, K, V)
    out = torch.einsum("bhk,bhkv->bhv", r, S + u[None, :, :, None] * kv)
    return w[..., :, None] * S + kv, out


def wkv_chunk(S0, rc, kc, vc, wc, u):
    """Matrix-form WKV6 over one chunk. rc, kc, vc (B, c, H, 64) in the
    activation dtype, wc (B, c, H, 64) f32. Each step's log decay is
    clamped to [-5, 0], so exp(-L) stays inside f32 range for c * 5 < 88.
    Returns (S', y (B, c, H, V))."""
    c = rc.shape[1]
    la = torch.clamp(torch.log(torch.clamp_min(wc, 1e-38)), -5.0, 0.0)
    L = torch.cumsum(la, dim=1)                            # inclusive
    L_prev = L - la                                        # exclusive
    r_t = rc.float() * torch.exp(L_prev)
    k_s = kc.float() * torch.exp(-L)
    A = torch.einsum("bthk,bshk->btsh", r_t, k_s)          # (B, t, s, H)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                 device=rc.device), diagonal=-1)
    A = torch.where(mask[None, :, :, None], A, torch.zeros_like(A))
    diag = torch.einsum("bthk,hk->bth", (rc * kc).float(), u)
    vf = vc.float()
    y = (torch.einsum("btsh,bshv->bthv", A, vf)
         + torch.einsum("bthk,bhkv->bthv", r_t, S0)
         + diag[..., None] * vf)
    to_end = torch.exp(L[:, -1:] - L)                      # <= 1
    S_new = S0 * torch.exp(L[:, -1])[..., None] + torch.einsum(
        "bshk,bshv->bhkv", kc.float() * to_end, vf)
    return S_new, y


def _wkv_gated(p, y, g, dtype, c=slice(None)):
    """Per-head RMS norm of y (B, S, H, 64) f32, ln_x (its channels `c`)
    and the SiLU gate: the output projection's input."""
    B, S = y.shape[:2]
    ones = torch.ones((HD,), dtype=torch.float32, device=y.device)
    y = common.rms_norm(y, ones).reshape(B, S, -1)
    y = y * p["ln_x"]["scale"][c].float()
    return y.to(dtype) * F.silu(g)


def _time_mix(p, rt: Runtime, x, heads=None, ws=None):
    """WKV6 over the normed x (B, S, d) from a zero state, for the heads
    (h0, H) (all without `heads`; `ws` as in `time_mix_inputs`). Returns
    (the output projection's input (B, S, H * 64), the final state (B, H,
    64, 64) f32)."""
    B, S, d = x.shape
    h0, H = heads or (0, d // HD)
    r, k, v, g, w = time_mix_inputs(p, x, heads=heads, ws=ws)
    u = p["u"][h0:h0 + H].float()
    cl = min(rt.rwkv_chunk, S)
    if S % cl:
        raise ValueError(f"seq {S} must divide rwkv_chunk {cl}")
    if rt.rwkv_mode not in ("chunk", "scan"):
        raise ValueError(f"rwkv_mode {rt.rwkv_mode!r}")
    state = torch.zeros((B, H, HD, HD), dtype=torch.float32,
                        device=x.device)
    ys = []
    for i in range(0, S, cl):
        sl = slice(i, i + cl)
        if rt.rwkv_mode == "chunk":
            state, y = wkv_chunk(state, r[:, sl], k[:, sl], v[:, sl],
                                 w[:, sl], u)
            ys.append(y)
        else:
            for t in range(i, i + cl):
                state, out = wkv_step(state, r[:, t], k[:, t], v[:, t],
                                      w[:, t], u)
                ys.append(out[:, None])
    c = slice(h0 * HD, (h0 + H) * HD)
    return _wkv_gated(p, torch.cat(ys, dim=1), g, x.dtype, c), state


def rwkv_time_mix(p, cfg: ArchConfig, rt: Runtime, x):
    """Full-sequence WKV6 over the normed x (B, S, d) from a zero state.
    Returns (y (B, S, d), the final state (B, H, 64, 64) f32)."""
    h, state = _time_mix(p, rt, x)
    return h @ p["w_out"].to(x.dtype), state


def rwkv_time_mix_mesh(p, cfg: ArchConfig, lay, xs):
    """`rwkv_time_mix`'s output on a mesh (`tp.Layout`), xs each position's
    normed (B_loc, S, d) input gathered to full S (the token shift reads
    the previous token across chunk edges). With the d / 64 heads split
    over 'model' (`lay.split`) a position takes its heads' columns of r,
    k, v, g and the decay's second LoRA matrix, their `u` and `ln_x`, runs
    the WKV chunks and the group norm on them, and `tp.out_proj_rs`
    reduce-scatters its `w_out` rows' product; else every position runs
    the time mix whole and keeps its chunk."""
    split = lay.split(cfg.d_model // HD)
    hl = cfg.d_model // HD // lay.n_model if split else cfg.d_model // HD
    hs = mesh_mod.pmap(lambda i, x: _time_mix(
        p, lay.rt, x, (lay.rank(i) * hl, hl) if split else None,
        _read_proj(p, lay, i, hl))[0], xs)
    return tp.out_proj_rs(lay, hs, p["w_out"], split=split)


def _read_proj(p, lay, i: int, hl: int):
    """Position `i`'s columns of the `PROJ` projections for its `hl` heads
    at its 'model' rank (every head where `hl` is all of them), through
    `tp.take`."""
    return {n: tp.take(lay, i, p[n], 1, hl * HD) for n in PROJ}


def _channel_inputs(p, x, x_prev=None):
    """The channel mix's token-shifted key and receptance inputs."""
    xp = token_shift(x, x_prev)
    mu = p["mu"].to(x.dtype)
    return x + mu[0] * (xp - x), x + mu[1] * (xp - x)


def rwkv_channel_mix(p, x, x_prev=None):
    """Token-shifted squared-ReLU FFN over the normed x (B, S, d)."""
    xk, xr = _channel_inputs(p, x, x_prev)
    kk = torch.square(F.relu(xk @ p["w_k"].to(x.dtype)))
    vv = kk @ p["w_v"].to(kk.dtype)
    r = torch.sigmoid(xr @ p["w_r"].to(x.dtype))
    return r * vv


def rwkv_channel_mix_mesh(p, cfg: ArchConfig, lay, xs, x_prevs=None):
    """`rwkv_channel_mix` on a mesh (`tp.Layout`), xs each position's
    normed (B_loc, S, d) input gathered to full S (x_prevs: each
    position's token shift, as `rwkv_channel_mix`'s x_prev): with d_ff
    split over 'model' (`lay.split(d_ff)`) a position takes its columns
    of `w_k` and `tp.out_proj_rs` reduce-scatters (on a decode layout
    sums) its `w_v` rows' product; the receptance runs on the position's
    chunk of the sequence only."""
    split = lay.split(cfg.d_ff)
    n = cfg.d_ff // lay.n_model

    def inputs(i, x, x_prev):
        xk, xr = _channel_inputs(p, x, x_prev)
        w_k = tp.take(lay, i, p["w_k"], 1, n if split else cfg.d_ff)
        return (torch.square(F.relu(xk @ w_k.to(x.dtype))),
                torch.sigmoid(lay.local_seq(i, xr) @ p["w_r"].to(x.dtype)))

    kks, rs = mesh_mod.unzip(mesh_mod.pmap(
        inputs, xs, x_prevs or [None] * len(xs)), 2)
    vvs = tp.out_proj_rs(lay, kks, p["w_v"], split=split)
    return mesh_mod.pmap(lambda _, r, vv: r * vv, rs, vvs)


def init_rwkv_cache(cfg: ArchConfig, rows: int, n_layers: int, device=None,
                    heads: int = None):
    """Decode state of `rows` sessions: S (rows, L, H, 64, 64) f32 (H =
    `heads`, a decode mesh position's share, or d / 64) and the last
    normed time-mix and channel-mix inputs x_tm, x_cm (rows, L, d) in the
    activation dtype."""
    d = cfg.d_model
    return {
        "S": torch.zeros((rows, n_layers, heads or d // HD, HD, HD),
                         dtype=torch.float32, device=device),
        "x_tm": torch.zeros((rows, n_layers, d), dtype=cfg.adtype(),
                            device=device),
        "x_cm": torch.zeros((rows, n_layers, d), dtype=cfg.adtype(),
                            device=device),
    }


def rwkv_decode(p_time, p_chan, x_tok, S, x_tm, x_cm):
    """One token x_tok (B, 1, d) through time-mix and channel-mix with
    their pre-norms, against one layer's state S (B, H, 64, 64), x_tm and
    x_cm (B, d). Returns (x', S', the normed inputs h and h2 (B, d) that
    become x_tm and x_cm); the caller writes the new state. The decode
    step does not clamp the decay."""
    h = common.rms_norm(x_tok, p_time["norm"]["scale"])
    r, k, v, g, w = time_mix_inputs(p_time, h, x_tm)
    S_new, out = wkv_step(S, r[:, 0], k[:, 0], v[:, 0], w[:, 0],
                          p_time["u"].float())
    x1 = x_tok + _wkv_gated(p_time, out[:, None], g, x_tok.dtype) \
        @ p_time["w_out"].to(x_tok.dtype)
    h2 = common.rms_norm(x1, p_chan["norm"]["scale"])
    x2 = x1 + rwkv_channel_mix(p_chan, h2, x_cm)
    return x2, S_new, h[:, -1], h2[:, -1]


def rwkv_decode_mesh(p_time, p_chan, cfg: ArchConfig, lay, xs, Ss, x_tms,
                     x_cms):
    """`rwkv_decode` on a decode mesh (`tp.Layout(decode=True)`): xs holds
    each position's (B_loc, 1, d) residual, whole over its 'model' group,
    Ss, x_tms and x_cms its state of one layer. With the d / 64 heads
    split over 'model' (`lay.split`) position r of a group of m steps
    heads [r * H / m, (r + 1) * H / m): their columns of r, k, v, g and
    of the decay's second LoRA matrix, their `u`, their WKV state S
    (`init_rwkv_cache(heads=)`) and their `ln_x` channels (the group norm
    is per head: no collective); `w_out`'s partial products are summed
    (`tp.out_proj_rs`). The channel mix splits `w_k`'s columns by d_ff
    where 'model' divides it, `w_v`'s partial products summed, and runs
    the receptance whole. The norms and the token shifts x_tm and x_cm
    are whole. With a 'model' of 1 every position runs `rwkv_decode`.
    Returns (xs', S', x_tm', x_cm') a position."""
    if lay.n_model == 1:
        return mesh_mod.unzip(mesh_mod.pmap(
            lambda _, *a: rwkv_decode(p_time, p_chan, *a), xs, Ss, x_tms,
            x_cms), 4)
    split = lay.split(cfg.d_model // HD)
    hl = cfg.d_model // HD // lay.n_model if split else cfg.d_model // HD

    def time_mix(i, x, S, x_tm):
        h0 = lay.rank(i) * hl if split else 0
        h = common.rms_norm(x, p_time["norm"]["scale"])
        r, k, v, g, w = time_mix_inputs(p_time, h, x_tm, heads=(h0, hl),
                                        ws=_read_proj(p_time, lay, i, hl))
        S1, out = wkv_step(S, r[:, 0], k[:, 0], v[:, 0], w[:, 0],
                           p_time["u"][h0:h0 + hl].float())
        return (_wkv_gated(p_time, out[:, None], g, x.dtype,
                           slice(h0 * HD, (h0 + hl) * HD)), h, S1)

    ys, hs, S_new = mesh_mod.unzip(mesh_mod.pmap(time_mix, xs, Ss, x_tms),
                                   3)
    x1s = mesh_mod.pmap(lambda _, x, y: x + y, xs, tp.out_proj_rs(
        lay, ys, p_time["w_out"], split=split))
    h2s = mesh_mod.pmap(
        lambda _, x1: common.rms_norm(x1, p_chan["norm"]["scale"]), x1s)
    ys = rwkv_channel_mix_mesh(p_chan, cfg, lay, h2s, x_cms)
    return (mesh_mod.pmap(lambda _, x1, y: x1 + y, x1s, ys), S_new,
            mesh_mod.pmap(lambda _, h: h[:, -1], hs),
            mesh_mod.pmap(lambda _, h2: h2[:, -1], h2s))
