"""Element-selection primitives for cut-layer sparsification.

All functions act on the LAST axis (the instance feature axis `d`) and are
batched over leading axes; top-k is by magnitude.

`backend=` picks the CUDA kernel or its plain version
(`kernels._lib.resolve_backend`: None/"auto", "torch" or "cuda").
"""
from __future__ import annotations

import torch

from repro_torch.kernels._lib import resolve_backend
from repro_torch.kernels.randtopk import ops as tk_ops
from repro_torch.kernels.randtopk import ref as tk_ref


def topk_mask(x: torch.Tensor, k: int, *, backend: str = None):
    """Boolean mask of the k largest-|x| elements along the last axis."""
    d = x.shape[-1]
    if k >= d:
        return torch.ones(x.shape, dtype=torch.bool, device=x.device)
    return tk_ops.topk_mask_threshold(x, k, backend=backend)[0]


def kth_magnitude_threshold(x: torch.Tensor, k: int):
    """|x| value of the k-th largest element."""
    return torch.topk(x.abs().float(), k, dim=-1).values[..., -1]


def mask_from_indices(idx: torch.Tensor, d: int):
    """Boolean mask (..., d) with the integer indices (..., k) set."""
    out = torch.zeros(idx.shape[:-1] + (d,), dtype=torch.bool,
                      device=idx.device)
    return out.scatter_(-1, idx.long(), True)


def pack_mask_words(mask: torch.Tensor):
    """Boolean mask (..., d) -> int32 words (..., ceil(d/32)) holding the
    little-endian u32 bit pattern (bit j of the row is bit j%32 of word
    j//32)."""
    d = mask.shape[-1]
    nw = (d + 31) // 32
    m = mask.to(torch.int64)
    pad = nw * 32 - d
    if pad:
        m = torch.nn.functional.pad(m, (0, pad))
    m = m.reshape(m.shape[:-1] + (nw, 32))
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    words = (m << shifts).sum(dim=-1)          # < 2**32, exact in int64
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def unpack_mask_words(words, d: int):
    """Inverse of `pack_mask_words`; bits at positions >= d are ignored.
    `& 1` after the shift: `>>` on an int32 word with bit 31 set
    sign-extends."""
    words = torch.as_tensor(words)
    if words.dtype != torch.int32:
        words = words.to(torch.int64).to(torch.int32)
    nw = words.shape[-1]
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(words.shape[:-1] + (nw * 32,))[..., :d].bool()


def binomial_nontop_count(generator: torch.Generator, alpha: float, k: int,
                          d: int, batch_shape, device=None):
    """m ~ Binomial(k, alpha) per instance, clipped to the pool sizes — the
    number of non-top-k picks in Eq. (7). Shape (*batch_shape, 1)."""
    u = torch.rand(tuple(batch_shape) + (k,), generator=generator,
                   device=device)
    m = (u < alpha).sum(dim=-1, keepdim=True)
    return torch.clamp(m, 0, min(k, d - k))


def gumbel_noise(generator: torch.Generator, shape, device=None):
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, tiny, 1.0)))


def randtopk_mask(x: torch.Tensor, k: int, alpha: float,
                  generator: torch.Generator, *, backend: str = None):
    """Randomized top-k selection mask, Eq. (7): exactly k elements, each
    draw a top-k element w.p. 1-alpha and a non-top-k one w.p. alpha.

    The noise is drawn here from `generator` and handed to the plain
    version as data (`kernels.randtopk.ref.randtopk_mask`); its CUDA kernel
    is not ported yet, so every backend runs the plain version."""
    d = x.shape[-1]
    if k >= d:
        return torch.ones(x.shape, dtype=torch.bool, device=x.device)
    resolve_backend(backend, x)
    m = binomial_nontop_count(generator, alpha, k, d, x.shape[:-1],
                              device=x.device)
    g = gumbel_noise(generator, x.shape, device=x.device)
    return tk_ref.randtopk_mask(x, g, m, k)
