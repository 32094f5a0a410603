"""Plain PyTorch versions of the decode family.

`decode_to_slots` and `decode_rows` are what the launchers of the same
names in `csrc/decode_rows.cu` compute (the reference's
`decode_to_slots_kernel` and `decode_rows_kernel`, projection epilogue
included); the CPU tests run them and `chip_smoke.py` holds the kernels
against them on the card. Both sum duplicate sparse indices and drop
indices outside [0, d), as the Pallas compare-and-select does.
"""
from __future__ import annotations

import torch

from repro_torch.core.compressors import dequant, mask_expand_rows
from repro_torch.core.payload import KIND_LEAVES
from repro_torch.kernels.randtopk.ref import scatter_rows


def decode_block(kind: str, leaves, d: int):
    """Wire leaves (leading rows) -> dense f32 (..., d) rows."""
    if kind == "dense":
        return leaves[0].float()
    if kind == "slice":
        v = leaves[0].float()
        return torch.nn.functional.pad(v, (0, d - v.shape[-1]))
    if kind == "sparse":
        return scatter_rows(leaves[0].float(), leaves[1], d)
    if kind == "quant":
        return dequant(leaves[0], leaves[1])
    if kind == "sparse_quant":
        return scatter_rows(dequant(leaves[0], leaves[2]), leaves[1], d)
    if kind == "mask":
        return mask_expand_rows(leaves[0].float(), leaves[1], d)
    raise ValueError(kind)


def decode_rows(p, dtype=torch.float32, project=None):
    """Any payload -> dense (..., d) rows in `dtype`; with `project` (a
    (d, p) matrix) the f32 rows times it, (..., p) in `dtype`."""
    leaves = [getattr(p, n) for n in KIND_LEAVES[p.meta.kind]]
    rows = decode_block(p.meta.kind, leaves, p.meta.d)
    if project is not None:
        rows = rows @ project.float()
    return rows.to(dtype)


def decode_to_slots(xbuf, leaves, slots, kind: str, d: int):
    """Decode flush rows (leading dim n) into `xbuf.view(-1, d)[slots]`, in
    place, in xbuf's dtype. Rows aimed at the same slot (the scratch-row
    padding) all carry identical zero rows."""
    rows = decode_block(kind, leaves, d).reshape(-1, d)
    xbuf.view(-1, d)[slots.long()] = rows.to(xbuf.dtype)
    return xbuf
