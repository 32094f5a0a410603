"""Plain PyTorch versions of the decode family.

`decode_to_slots` is what `csrc/decode_to_slots.cu` computes; the CPU
tests run it and `chip_smoke.py` holds the kernel against it on the card.
`decode_rows` is the plain version of the reference's `decode_rows_kernel`,
whose CUDA kernel is not ported yet. Both sum duplicate sparse indices and
drop indices outside [0, d), as the Pallas compare-and-select does.
"""
from __future__ import annotations

import torch

from repro_torch.core.compressors import dequant, mask_expand_rows
from repro_torch.core.payload import KIND_LEAVES


def _scatter_sum(vals, idx, d: int):
    idx = idx.long()
    ok = (idx >= 0) & (idx < d)
    out = torch.zeros(vals.shape[:-1] + (d,), dtype=torch.float32,
                      device=vals.device)
    return out.scatter_add_(-1, torch.where(ok, idx, 0),
                            torch.where(ok, vals.float(), 0.0))


def decode_block(kind: str, leaves, d: int):
    """Wire leaves (leading rows) -> dense f32 (..., d) rows."""
    if kind == "dense":
        return leaves[0].float()
    if kind == "slice":
        v = leaves[0].float()
        return torch.nn.functional.pad(v, (0, d - v.shape[-1]))
    if kind == "sparse":
        return _scatter_sum(leaves[0], leaves[1], d)
    if kind == "quant":
        return dequant(leaves[0], leaves[1])
    if kind == "sparse_quant":
        return _scatter_sum(dequant(leaves[0], leaves[2]), leaves[1], d)
    if kind == "mask":
        return mask_expand_rows(leaves[0].float(), leaves[1], d)
    raise ValueError(kind)


def decode_rows(p, dtype=torch.float32):
    """Any payload -> dense (..., d) rows in `dtype`."""
    leaves = [getattr(p, n) for n in KIND_LEAVES[p.meta.kind]]
    return decode_block(p.meta.kind, leaves, p.meta.d).to(dtype)


def decode_to_slots(xbuf, leaves, slots, kind: str, d: int):
    """Decode flush rows (leading dim n) into `xbuf.view(-1, d)[slots]`, in
    place, in xbuf's dtype. Rows aimed at the same slot (the scratch-row
    padding) all carry identical zero rows."""
    rows = decode_block(kind, leaves, d).reshape(-1, d)
    xbuf.view(-1, d)[slots.long()] = rows.to(xbuf.dtype)
    return xbuf
