"""Wrappers of the encode kernels and the device wire path.

  * `encode_sections` — the serving client's whole codec in one launch
    (`csrc/encode_rows.cu`): activation rows [+ selection mask, or the
    rows' own top-k] -> a device `Payload` and its packed wire sections.
  * `encode_rows` — activation rows [+ selection mask] -> a device
    `Payload` in one kernel launch (the same kernel), every kind.
  * `pack_bits` — flat ints -> u32 words (as int32) whose first
    ceil(n * width / 8) bytes equal `core.wire._pack_bits`
    (`csrc/pack_bits.cu`: the fused encode's `pack_rows` over the stream
    as one row).
  * `pack_payload` / `section_nbytes` / `sections_to_bytes` — the wire
    bitstream assembled on the device as word sections, so the host only
    pulls them, cuts each to its exact byte length and frames it.

A wrapper takes its plain version (`ref.py`) for a tensor on the CPU or
when `backend="torch"` asks for it; otherwise it launches the kernel or
raises (`_lib.resolve_backend`).

`encode_sections` runs once per served token, so its host path is kept
short: the checks and the output layout of a key (kind, x's shape and
dtype, k, bits, select) are resolved once, in `sections_plan` (for
`encode_rows`, `encode_plan`; for `pack_bits`, `pack_plan`), and a call
then allocates the buffers and launches.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import wire
from repro_torch.core.payload import KIND_LEAVES, KINDS, Payload, PayloadMeta
from repro_torch.kernels import _lib
from repro_torch.kernels.encode import ref

MAX_D = 16384
#: payload kinds whose encode needs the selection mask
MASK_KINDS = ("sparse", "sparse_quant", "mask")


def _meta(kind: str, d: int, k: int, bits: int) -> PayloadMeta:
    return PayloadMeta(kind, d=d, k=k if kind != "quant" else 0,
                       bits=bits if kind in ("quant", "sparse_quant") else 0)


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


class EncodePlan(NamedTuple):
    """What `encode_rows` needs of one key besides the tensors."""

    meta: PayloadMeta
    names: tuple            # leaf field names, KIND_LEAVES order
    leaves: tuple           # (shape, dtype) of each output leaf
    pad: tuple              # zeros for the kernel outputs the kind lacks
    rows: int
    kind_id: int
    x_bf16: int
    masked: bool


@lru_cache(maxsize=1024)
def encode_plan(kind: str, shape, dtype, k: int, bits: int) -> EncodePlan:
    """Check one encode key (kind, x's shape and dtype, k, bits) and lay
    out its outputs; raises on what the kernel does not take."""
    d = shape[-1]
    meta = _meta(kind, d, k, bits)
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"encode kernel takes f32/bf16, got {dtype}")
    if not 1 <= d <= MAX_D or (kind in MASK_KINDS + ("slice",)
                               and not 1 <= k <= d):
        raise ValueError(f"encode {kind}: bad d={d} / k={k}")
    if kind in ("quant", "sparse_quant") and not 1 <= bits <= 8:
        raise ValueError(f"encode {kind}: bits={bits} not in 1..8")
    lead = tuple(shape[:-1])
    leaves = tuple((lead + (w,), dt) for w, dt in _out_descr(kind, d, k))
    return EncodePlan(meta, KIND_LEAVES[kind], leaves,
                      (0,) * (3 - len(leaves)), math.prod(lead),
                      KINDS.index(kind), int(dtype == torch.bfloat16),
                      kind in MASK_KINDS)


def encode_rows(x, kind: str, *, k: int = 0, bits: int = 0, mask=None,
                backend=None) -> Payload:
    """Fused one-pass encode of activation rows to a device Payload; values
    come back in ascending-index order, matching `Compressor.encode`."""
    if _lib.resolve_backend(backend, x) == "torch":
        outs = ref.encode_rows(x, kind, k, bits, mask)
        return Payload(meta=_meta(kind, x.shape[-1], k, bits),
                       **dict(zip(KIND_LEAVES[kind], outs)))
    plan = encode_plan(kind, x.shape, x.dtype, k, bits)
    if plan.masked and (mask is None or not mask.is_cuda):
        raise ValueError(f"{kind} encode needs a CUDA mask of x's shape")
    return launch_encode(plan, x, mask)


def launch_encode(plan: EncodePlan, x, mask) -> Payload:
    """Allocate the outputs of a checked key (`encode_plan`), one
    `new_empty` per leaf (faster on the card's host than views carved from
    one buffer), and launch `encode_rows`. The tensors' device is not
    checked here."""
    if not x.is_contiguous():
        x = x.contiguous()
    m_ptr = 0
    if plan.masked:
        if mask is None or mask.shape != x.shape:
            raise ValueError(f"{plan.meta.kind} encode needs a mask of x's "
                             f"shape")
        if mask.dtype != torch.bool and mask.dtype != torch.uint8:
            mask = mask != 0
        if not mask.is_contiguous():
            mask = mask.contiguous()
        m_ptr = mask.data_ptr()
    outs = [x.new_empty(shape, dtype=dt) for shape, dt in plan.leaves]
    if plan.rows:
        m = plan.meta
        _lib.launch("encode_rows", x.data_ptr(), plan.x_bf16, m_ptr,
                    plan.rows, m.d, plan.kind_id, m.k, m.bits,
                    *[o.data_ptr() for o in outs], *plan.pad,
                    _lib.stream_handle(x))
    return Payload(plan.meta, **dict(zip(plan.names, outs)))


def _words(count: int, width: int) -> int:
    """int32 words of `count` values packed at `width` bits (`pack_bits`)."""
    return (count + 31) // 32 * width


class PackPlan(NamedTuple):
    """What `pack_bits` needs of one key besides the tensor."""

    n: int                  # values
    width: int
    words: int              # int32 words of the output


@lru_cache(maxsize=1024)
def pack_plan(n: int, width: int, dtype) -> PackPlan:
    """Check one pack key (value count, width, dtype); raises on what the
    kernel does not take."""
    if not 1 <= width <= 32:
        raise ValueError(f"pack width {width} not in 1..32")
    if dtype != torch.int32:
        raise TypeError(f"pack kernel takes int32, got {dtype}")
    return PackPlan(n, width, _words(n, width))


def pack_bits(vals, width: int, *, backend=None):
    """Flat int32 values of `width` bits -> little-endian u32 words (as
    int32)."""
    if _lib.resolve_backend(backend, vals) == "torch":
        return ref.pack_bits(vals, width)
    return launch_pack(pack_plan(vals.numel(), width, vals.dtype), vals)


def launch_pack(plan: PackPlan, vals):
    """Allocate the words of a checked key (`pack_plan`) and launch
    `pack_bits` on `vals`, made contiguous if it is not."""
    if not vals.is_contiguous():
        vals = vals.contiguous()
    out = vals.new_empty((plan.words,))
    if plan.n:
        _lib.launch("pack_bits", vals.data_ptr(), plan.n, plan.width,
                    out.data_ptr(), _lib.stream_handle(vals))
    return out


def pack_payload(p: Payload, *, backend=None):
    """Assemble `wire.encode_payload(p)`'s bitstream on the device as int32
    word sections (`ref.payload_sections`), each packed stream by the
    `pack_bits` kernel or its plain version per `backend`."""
    m = p.meta
    leaves = {name: getattr(p, name) for name in KIND_LEAVES[m.kind]}
    return ref.payload_sections(
        m.kind, m.d, m.bits, leaves,
        pack=lambda v, w: pack_bits(v, w, backend=backend))


class SectionsPlan(NamedTuple):
    """What `encode_sections` needs of one key besides the tensors: the
    buffers to allocate, and where each leaf, section and kernel output
    lies in them."""

    meta: PayloadMeta
    rows: int
    kind_id: int
    x_bf16: int
    select: int
    masked: bool            # a mask tensor comes in
    bufs: tuple             # (shape, dtype) of each buffer
    leaves: tuple           # (name, buf, None | (shape, stride)): the
                            # buffer itself, or an f32 view of its prefix
    sections: tuple         # (buf, None | shape): the buffer or a view
    outs: tuple             # (buf, byte offset) or None: out0, out1, out2,
                            # idx_words, code_words


def _strides(shape) -> tuple:
    return tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))


@lru_cache(maxsize=1024)
def sections_plan(kind: str, shape, dtype, k: int, bits: int,
                  select: bool) -> SectionsPlan:
    """Check one fused-encode key and lay out its buffers. The sections are
    `ref.payload_sections`' (int32, 1-D; the mask words (n, W)); a leaf
    that is a prefix of a section (sparse values, quant headers, mask and
    dense values) is an f32 view of it, so the launch writes it once. A
    leaf or section that is a buffer of its own is allocated in its shape,
    so a call makes as few views as it can (each costs the host a few
    us)."""
    ep = encode_plan(kind, shape, dtype, k, bits)
    if select and kind not in MASK_KINDS:
        raise ValueError(f"encode {kind}: select= takes a mask kind")
    m, n, lead = ep.meta, ep.rows, tuple(shape[:-1])
    d, i32 = m.d, torch.int32
    r = wire.index_bits(d)
    nk = n * k

    def flat(numel):
        return ((numel,), i32)

    def prefix(name, buf, width):
        s = lead + (width,)
        return (name, buf, (s, _strides(s)))

    if kind in ("dense", "slice"):
        w = d if kind == "dense" else k
        bufs = (flat(n * w),)
        leaves = (prefix("values", 0, w),)
        outs = ((0, 0), None, None, None, None)
    elif kind == "sparse":
        bufs = (flat(nk + _words(nk, r)), (lead + (k,), i32))
        leaves = (prefix("values", 0, k), ("indices", 1, None))
        outs = ((0, 0), (1, 0), None, (0, 4 * nk), None)
    elif kind == "quant":
        bufs = (flat(2 * n + _words(n * d, bits)), (lead + (d,), i32))
        leaves = (("values", 1, None), prefix("header", 0, 2))
        outs = ((1, 0), (0, 0), None, None, (0, 8 * n))
    elif kind == "sparse_quant":
        bufs = (flat(2 * n + _words(nk, r)), flat(_words(nk, bits)),
                (lead + (k,), i32), (lead + (k,), i32))
        leaves = (("values", 2, None), ("indices", 3, None),
                  prefix("header", 0, 2))
        outs = ((2, 0), (3, 0), (0, 0), (0, 8 * n), (1, 0))
    else:                                                   # mask
        nw = wire.mask_words(d)
        bufs = (flat(nk), (lead + (nw,), i32))
        leaves = (prefix("values", 0, k), ("indices", 1, None))
        outs = ((0, 0), (1, 0), None, None, None)
    sections = ((0, None),)
    if kind == "sparse_quant":
        sections = ((0, None), (1, None))
    elif kind == "mask":
        words = (n, wire.mask_words(d))
        sections = ((0, None), (1, None if lead == words[:1] else words))
    return SectionsPlan(m, n, ep.kind_id, ep.x_bf16, int(select),
                        ep.masked and not select, bufs, leaves, sections,
                        outs)


def sections_alloc(plan: SectionsPlan, x):
    """The buffers of a checked key, one `new_empty` each."""
    return [x.new_empty(shape, dtype=dt) for shape, dt in plan.bufs]


def sections_args(plan: SectionsPlan, x, m_ptr: int, bufs) -> tuple:
    """The `encode_sections` launch arguments for allocated buffers."""
    base = [b.data_ptr() for b in bufs]
    outs = [0 if o is None else base[o[0]] + o[1] for o in plan.outs]
    m = plan.meta
    return (x.data_ptr(), plan.x_bf16, m_ptr, plan.rows, m.d, plan.kind_id,
            m.k, m.bits, plan.select, *outs, _lib.stream_handle(x))


def launch_sections(plan: SectionsPlan, x, mask):
    """Allocate the buffers of a checked key (`sections_plan`) and launch
    `encode_sections`: one launch for the leaves and the wire sections.
    Returns (Payload, sections). The tensors' device is not checked
    here."""
    if not x.is_contiguous():
        x = x.contiguous()
    m_ptr = 0
    if plan.masked:
        if mask is None or mask.shape != x.shape:
            raise ValueError(f"{plan.meta.kind} encode needs a mask of x's "
                             f"shape")
        if mask.dtype != torch.bool and mask.dtype != torch.uint8:
            mask = mask != 0
        if not mask.is_contiguous():
            mask = mask.contiguous()
        m_ptr = mask.data_ptr()
    bufs = sections_alloc(plan, x)
    if plan.rows:
        _lib.launch("encode_sections", *sections_args(plan, x, m_ptr, bufs))
    leaves = {name: bufs[b] if view is None else
              bufs[b].view(torch.float32).as_strided(*view)
              for name, b, view in plan.leaves}
    sections = tuple(bufs[b] if shape is None else bufs[b].view(shape)
                     for b, shape in plan.sections)
    return Payload(plan.meta, **leaves), sections


def encode_sections(x, kind: str, *, k: int = 0, bits: int = 0, mask=None,
                    select: bool = False, backend=None):
    """The serving client's whole codec in one launch: activation rows ->
    (device Payload, its packed int32 wire sections), byte-identical to
    `pack_payload(encode_rows(...))`. The support of a mask kind is `mask`
    or, with `select`, the row's own top-k by |x| (the kernel selects it:
    no mask reaches device memory)."""
    if _lib.resolve_backend(backend, x) == "torch":
        leaves, sections = ref.encode_sections(x, kind, k, bits, mask,
                                               select)
        return (Payload(meta=_meta(kind, x.shape[-1], k, bits),
                        **dict(zip(KIND_LEAVES[kind], leaves))), sections)
    plan = sections_plan(kind, x.shape, x.dtype, k, bits, bool(select))
    if plan.masked and (mask is None or mask.device != x.device):
        raise ValueError(f"{kind} encode needs a mask on x's device")
    return launch_sections(plan, x, mask)


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
