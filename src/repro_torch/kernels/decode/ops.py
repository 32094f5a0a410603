"""Wrapper of the decode-to-slots kernel (`csrc/decode_to_slots.cu`): the
serving arena's decode -> xbuf seam. Takes the plain version (`ref.py`) for
an xbuf on the CPU or when `backend="torch"` asks for it; otherwise it
launches the kernel or raises (`_lib.resolve_backend`)."""
from __future__ import annotations

import torch

from repro_torch.core.payload import KIND_LEAVES, KINDS, Payload
from repro_torch.kernels import _lib
from repro_torch.kernels.decode import ref

MAX_D = 16384


def _leaf_widths(p: Payload):
    m = p.meta
    nw = (m.d + 31) // 32
    return {
        "dense": (m.d,), "slice": (m.k,), "sparse": (m.k, m.k),
        "quant": (m.d, 2), "sparse_quant": (m.k, m.k, 2), "mask": (m.k, nw),
    }[m.kind]


def decode_rows_to_slots(xbuf: torch.Tensor, p: Payload, slots, *,
                         backend=None):
    """Decode a stacked flush payload (leading dim n = flush rows) straight
    into `xbuf[slots]`, IN PLACE (the reference donates xbuf through the
    kernel; here the kernel writes the rows of the live buffer). xbuf is
    (C + 1, ..., d); untouched rows keep their contents. Returns xbuf."""
    kind, d = p.meta.kind, p.meta.d
    leaves = [getattr(p, n) for n in KIND_LEAVES[kind]]
    if _lib.resolve_backend(backend, xbuf) == "torch":
        return ref.decode_to_slots(xbuf, leaves, slots, kind, d)
    if xbuf.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode kernel writes f32/bf16 xbuf, got "
                        f"{xbuf.dtype}")
    if not xbuf.is_contiguous() or xbuf.shape[-1] != d or d > MAX_D:
        raise ValueError(f"xbuf must be contiguous (..., {d}), d <= {MAX_D}")
    cap1 = xbuf.numel() // d
    n = slots.shape[0]
    if not (slots.is_cuda and slots.dtype == torch.int32
            and slots.is_contiguous() and slots.dim() == 1):
        raise TypeError("slots must be a contiguous int32 CUDA vector")
    flat = []
    for leaf, w in zip(leaves, _leaf_widths(p)):
        if not (leaf.is_cuda and leaf.is_contiguous()
                and leaf.numel() == n * w):
            raise ValueError(f"{kind} leaf of shape {tuple(leaf.shape)} is "
                             f"not a contiguous CUDA ({n}, {w}) block")
        want = torch.float32 if leaf.is_floating_point() else torch.int32
        if leaf.dtype != want:
            raise TypeError(f"{kind} leaf dtype {leaf.dtype}, want {want}")
        flat.append(leaf)
    vals = flat[0]
    idx = flat[1] if kind in ("sparse", "sparse_quant", "mask") else None
    hdr = flat[-1] if kind in ("quant", "sparse_quant") else None
    if n:
        _lib.launch("decode_to_slots", xbuf.data_ptr(),
                    int(xbuf.dtype == torch.bfloat16), cap1, d,
                    slots.data_ptr(), n, KINDS.index(kind), p.meta.k,
                    vals.data_ptr(), 0 if idx is None else idx.data_ptr(),
                    0 if hdr is None else hdr.data_ptr(),
                    _lib.stream_handle(xbuf))
    return xbuf
