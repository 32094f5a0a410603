"""Wrappers of the encode kernels and the device wire path.

  * `encode_rows` — activation rows [+ selection mask] -> a device
    `Payload` in one kernel launch (`csrc/encode_rows.cu`), every kind.
  * `pack_bits` — flat ints -> u32 words (as int32) whose first
    ceil(n * width / 8) bytes equal `core.wire._pack_bits`
    (`csrc/pack_bits.cu`).
  * `pack_payload` / `section_nbytes` / `sections_to_bytes` — the wire
    bitstream assembled on the device as word sections, so the host only
    pulls them, cuts each to its exact byte length and frames it.

A wrapper takes its plain version (`ref.py`) for a tensor on the CPU or
when `backend="torch"` asks for it; otherwise it launches the kernel or
raises (`_lib.resolve_backend`).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from repro_torch.core import wire
from repro_torch.core.payload import KIND_LEAVES, KINDS, Payload, PayloadMeta
from repro_torch.kernels import _lib
from repro_torch.kernels.encode import ref

MAX_D = 16384
#: payload kinds whose encode needs the selection mask
MASK_KINDS = ("sparse", "sparse_quant", "mask")


def _out_descr(kind: str, d: int, k: int):
    """(width, dtype) per output leaf, in KIND_LEAVES order."""
    f32, i32 = torch.float32, torch.int32
    return {
        "dense": ((d, f32),),
        "slice": ((k, f32),),
        "sparse": ((k, f32), (k, i32)),
        "quant": ((d, i32), (2, f32)),
        "sparse_quant": ((k, i32), (k, i32), (2, f32)),
        "mask": ((k, f32), (wire.mask_words(d), i32)),
    }[kind]


def encode_rows(x, kind: str, *, k: int = 0, bits: int = 0, mask=None,
                backend=None) -> Payload:
    """Fused one-pass encode of activation rows to a device Payload; values
    come back in ascending-index order, matching `Compressor.encode`."""
    d = x.shape[-1]
    meta = PayloadMeta(kind, d=d, k=k if kind != "quant" else 0,
                       bits=bits if kind in ("quant", "sparse_quant") else 0)
    if _lib.resolve_backend(backend, x) == "torch":
        outs = ref.encode_rows(x, kind, k, bits, mask)
    else:
        outs = _launch_encode(x, kind, k, bits, mask)
    return Payload(meta=meta, **dict(zip(KIND_LEAVES[kind], outs)))


def _launch_encode(x, kind: str, k: int, bits: int, mask):
    d = x.shape[-1]
    lead = x.shape[:-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"encode kernel takes f32/bf16, got {x.dtype}")
    if d > MAX_D or (kind in MASK_KINDS + ("slice",) and not 1 <= k <= d):
        raise ValueError(f"encode {kind}: bad d={d} / k={k}")
    if kind in ("quant", "sparse_quant") and not 1 <= bits <= 8:
        raise ValueError(f"encode {kind}: bits={bits} not in 1..8")
    x2 = x.contiguous().view(-1, d)
    rows = x2.shape[0]
    m_ptr = 0
    if kind in MASK_KINDS:
        if mask is None or mask.shape != x.shape or not mask.is_cuda:
            raise ValueError(f"{kind} encode needs a CUDA mask of x's shape")
        m2 = (mask if mask.dtype == torch.bool else mask != 0).contiguous()
        m_ptr = m2.data_ptr()
    outs = [torch.empty((rows, w), dtype=dt, device=x.device)
            for w, dt in _out_descr(kind, d, k)]
    ptrs = [o.data_ptr() for o in outs] + [0] * (3 - len(outs))
    if rows:
        _lib.launch("encode_rows", x2.data_ptr(),
                    int(x.dtype == torch.bfloat16), m_ptr, rows, d,
                    KINDS.index(kind), k, bits, *ptrs, _lib.stream_handle(x))
    return tuple(o.view(lead + (o.shape[-1],)) for o in outs)


def pack_bits(vals, width: int, *, backend=None):
    """Flat int32 values of `width` bits -> little-endian u32 words (as
    int32)."""
    if _lib.resolve_backend(backend, vals) == "torch":
        return ref.pack_bits(vals, width)
    if not 1 <= width <= 32:
        raise ValueError(f"pack width {width} not in 1..32")
    if vals.dtype != torch.int32:
        raise TypeError(f"pack kernel takes int32, got {vals.dtype}")
    v = vals.contiguous().view(-1)
    n = v.shape[0]
    out = torch.empty(((n + 31) // 32 * width,), dtype=torch.int32,
                      device=vals.device)
    if n:
        _lib.launch("pack_bits", v.data_ptr(), n, width, out.data_ptr(),
                    _lib.stream_handle(vals))
    return out


def _f32_words(a):
    """f32 leaf -> its u32 bit pattern as int32, flattened."""
    return a.float().contiguous().view(torch.int32).reshape(-1)


def pack_payload(p: Payload, *, backend=None):
    """Assemble `wire.encode_payload(p)`'s bitstream on the device as int32
    word sections. Sections split exactly where a bit-packed stream ends on
    a non-word byte boundary (so each section's wire bytes are a prefix of
    its own bytes): sparse_quant is two sections, mask two (the second
    stays (n, W) for the host's per-row byte cut), the others one."""
    m = p.meta
    kind, d = m.kind, m.d
    if kind in ("dense", "slice"):
        return (_f32_words(p.values),)
    if kind == "sparse":
        return (torch.cat([_f32_words(p.values),
                           pack_bits(p.indices, wire.index_bits(d),
                                     backend=backend)]),)
    if kind == "quant":
        return (torch.cat([_f32_words(p.header),
                           pack_bits(p.values, m.bits, backend=backend)]),)
    if kind == "sparse_quant":
        return (torch.cat([_f32_words(p.header),
                           pack_bits(p.indices, wire.index_bits(d),
                                     backend=backend)]),
                pack_bits(p.values, m.bits, backend=backend))
    if kind == "mask":
        n = int(np.prod(p.batch_shape, dtype=np.int64))
        return (_f32_words(p.values),
                p.indices.reshape(n, wire.mask_words(d)))
    raise ValueError(kind)


def section_nbytes(meta: PayloadMeta, batch_shape):
    """Exact wire bytes of each `pack_payload` section; their sum is
    `wire.payload_expected_nbytes(meta, batch_shape)`."""
    return _section_nbytes(meta, tuple(batch_shape))


@lru_cache(maxsize=4096)
def _section_nbytes(meta: PayloadMeta, batch_shape):
    n = int(np.prod(batch_shape, dtype=np.int64)) if batch_shape else 1
    kind, d, k, r = meta.kind, meta.d, meta.k, wire.index_bits(meta.d)
    if kind == "dense":
        return (4 * n * d,)
    if kind == "slice":
        return (4 * n * k,)
    if kind == "sparse":
        return (4 * n * k + (n * k * r + 7) // 8,)
    if kind == "quant":
        return (8 * n + (n * d * meta.bits + 7) // 8,)
    if kind == "sparse_quant":
        return (8 * n + (n * k * r + 7) // 8, (n * k * meta.bits + 7) // 8)
    if kind == "mask":
        return (4 * n * k, n * wire.mask_row_nbytes(d))
    raise ValueError(kind)


def sections_to_bytes(meta: PayloadMeta, batch_shape, sections) -> bytes:
    """Host side of the device wire path: pull each section (`.cpu()`
    synchronizes) and cut it to its exact byte length. Byte-identical to
    `wire.encode_payload` of the same payload."""
    parts = []
    for sec, nb in zip(sections, section_nbytes(meta, batch_shape)):
        a = sec.cpu().numpy() if torch.is_tensor(sec) else np.asarray(sec)
        if meta.kind == "mask" and a.ndim == 2:
            parts.append(wire.mask_words_to_bytes(a, meta.d))
        else:
            parts.append(a.tobytes()[:nb])
    return b"".join(parts)
