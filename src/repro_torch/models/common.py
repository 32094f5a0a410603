"""Shared layers: RMS and layer norm, RoPE, sinusoidal positions,
initializers, the parameter count."""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_leaves


def normal_init(generator: torch.Generator, shape, dtype, scale=0.02,
                device=None):
    """N(0, scale^2) weights drawn in f32 from `generator`, then cast."""
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (w.mul_(scale)).to(dtype)


def count_params(tree) -> int:
    """The number of elements over every tensor leaf of `tree`."""
    return sum(t.numel() for t in tree_leaves(tree))


def init_norm(d, dtype, device=None, kind="rms", lead=()):
    """A norm's weights, with leading (stacking) axes `lead`: a scale of
    ones, and for layer norm a bias of zeros."""
    shape = tuple(lead) + (d,)
    p = {"scale": torch.ones(shape, dtype=dtype, device=device)}
    if kind == "layer":
        p["bias"] = torch.zeros(shape, dtype=dtype, device=device)
    return p


def norm_spec(kind="rms"):
    """A norm's layout: replicated (the reference's `common.norm_spec`).
    A layout, the reference's `PartitionSpec` as a plain tuple: one entry
    per leading dimension, None (whole), a mesh axis name or a tuple of
    names; dimensions past its length are whole."""
    if kind == "layer":
        return {"scale": (), "bias": ()}
    return {"scale": ()}


def stacked_spec(spec, n_prefix=1):
    """`spec` (a tree of layouts) with `n_prefix` whole leading dimensions
    in front of every leaf: the layer stacking."""
    if isinstance(spec, dict):
        return {k: stacked_spec(v, n_prefix) for k, v in spec.items()}
    return (None,) * n_prefix + tuple(spec)


def block_reads(spec, **blocks):
    """`spec` (a tree of layouts) as a tree of bools: True at every leaf
    under a key named True in `blocks`, False elsewhere. A module's
    `*_reads` beside its `*_spec` builds with it the leaves each position
    reads as exactly its 'model' block (`launch.specs.use_layouts`)."""
    unknown = set(blocks) - set(spec)
    if unknown:
        raise ValueError(f"{sorted(unknown)} are not leaves of {spec}")

    def fill(tree, flag):
        if isinstance(tree, dict):
            return {k: fill(v, flag) for k, v in tree.items()}
        return flag

    return {k: fill(v, bool(blocks.get(k, False))) for k, v in spec.items()}


def rms_norm(x, scale, eps=1e-6):
    """RMS norm computed in f32, returned in x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    """Layer norm computed in f32 (population variance), returned in x's
    dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def apply_norm(x, p, kind="rms"):
    """The norm `kind` ("rms" or "layer", `ArchConfig.norm`) with the
    weights `p`."""
    if kind == "layer":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


def tanh_gate(p, y):
    """tanh(p["gate"]) * y, the gate's tanh taken in f32: a gated cross
    block's output (0 while the gate is at its initial 0)."""
    return torch.tanh(p["gate"].float()).to(y.dtype) * y


def rope_freqs(hd: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta,
                                  device=x.device))


def rope_tables(positions, hd: int, theta: float, device=None):
    """RoPE's (cos, sin), each (..., S, 1, hd/2), at `positions`."""
    freqs = rope_freqs(hd, theta, device=device)            # (hd/2,)
    ang = positions[..., None].float() * freqs              # (..., S, hd/2)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rotate(x, cos, sin):
    """x (..., S, H, hd) rotated by RoPE tables (`rope_tables`)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def sinusoidal_positions(n_pos: int, d: int, device=None):
    """(n_pos, d) f32: sin then cos of pos / 10000^(2i/d), i < d/2. The
    power is taken in f64 and rounded to f32 (the correctly rounded value,
    which XLA's f32 power gives and torch's f32 power misses by an ulp
    at some i: an ulp of the angle at pos 1499 is 1.2e-4)."""
    pos = torch.arange(n_pos, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * dim / d).double()).float()
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
