"""Plain PyTorch versions of the encode family: what `csrc/encode_rows.cu`
and `csrc/pack_bits.cu` compute. The CPU tests run them; `chip_smoke.py`
holds the kernels against them on the card.

Outputs are in the device dtypes of `core.payload`: f32 values, int32
codes, int32 indices, int32 words holding the u32 bit pattern.
"""
from __future__ import annotations

import torch

from repro_torch.core.compressors import quantize_rows
from repro_torch.core.selection import pack_mask_words


def u32_to_i32(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same bit pattern."""
    return torch.where(t >= 2 ** 31, t - 2 ** 32, t).to(torch.int32)


def gather_block(x, mask, k: int):
    """Compact the masked lanes of (..., d) into (..., k) f32 values +
    int32 indices in ascending-index order; slots past the row's count of
    set lanes stay zero."""
    d = x.shape[-1]
    mask = mask.bool()
    pos = torch.cumsum(mask.to(torch.int64), dim=-1) - 1
    hit = mask & (pos < k)
    target = torch.where(hit, pos, torch.full_like(pos, k))   # k = discard
    lanes = torch.arange(d, device=x.device).expand(x.shape)
    vals = torch.zeros(x.shape[:-1] + (k + 1,), dtype=torch.float32,
                       device=x.device)
    idx = torch.zeros(x.shape[:-1] + (k + 1,), dtype=torch.int64,
                      device=x.device)
    vals.scatter_(-1, target, x.float())
    idx.scatter_(-1, target, lanes)
    return vals[..., :k].contiguous(), idx[..., :k].to(torch.int32)


def encode_rows(x, kind: str, k: int = 0, bits: int = 0, mask=None):
    """(..., d) activation [+ selection mask] -> the payload kind's leaves
    (`core.payload.KIND_LEAVES[kind]` order)."""
    xf = x.float()
    if kind == "dense":
        return (xf,)
    if kind == "slice":
        return (xf[..., :k].contiguous(),)
    if kind == "quant":
        return quantize_rows(xf, bits)
    vals, idx = gather_block(xf, mask, k)
    if kind == "sparse":
        return vals, idx
    if kind == "sparse_quant":
        codes, hdr = quantize_rows(vals, bits, selected=True)
        return codes, idx, hdr
    if kind == "mask":
        return vals, pack_mask_words(mask.bool())
    raise ValueError(kind)


def pack_bits(vals, width: int):
    """Flat unsigned ints -> (ceil(n/32) * width,) int32 words holding the
    little-endian u32 bitstream: value i at stream bits [i*w, (i+1)*w),
    bit j of the stream at bit j%32 of word j//32."""
    assert 1 <= width <= 32
    v = vals.reshape(-1).to(torch.int64) & ((1 << width) - 1)
    n = v.shape[0]
    groups = (n + 31) // 32
    v = torch.nn.functional.pad(v, (0, groups * 32 - n)).reshape(groups, 32)
    cols = torch.zeros((groups, width), dtype=torch.int64, device=v.device)
    for i in range(32):
        j, off = divmod(i * width, 32)
        cols[:, j] |= (v[:, i] << off) & 0xFFFFFFFF
        if off and off + width > 32:
            cols[:, j + 1] |= v[:, i] >> (32 - off)
    return u32_to_i32(cols.reshape(groups * width))
