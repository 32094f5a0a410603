"""Shared layers: RMS norm, RoPE, initializers."""
from __future__ import annotations

import torch


def normal_init(generator: torch.Generator, shape, dtype, scale=0.02,
                device=None):
    """N(0, scale^2) weights drawn in f32 from `generator`, then cast."""
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (w.mul_(scale)).to(dtype)


def init_norm(d, dtype, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rms_norm(x, scale, eps=1e-6):
    """RMS norm computed in f32, returned in x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rope_freqs(hd: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)          # (hd/2,)
    ang = positions[..., None].float() * freqs              # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)
