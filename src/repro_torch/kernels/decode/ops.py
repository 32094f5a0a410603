"""Wrappers of the decode family's kernels (`csrc/decode_rows.cu`):
`decode_rows`, the dense (optionally projected) rows of any payload, and
`decode_rows_to_slots` (its `decode_to_slots` launcher), the serving
arena's decode -> xbuf seam. Each takes the plain version (`ref.py`) for
tensors on the CPU or when `backend="torch"` asks for it; otherwise it
launches its kernel or raises (`_lib.resolve_backend`).

`decode_rows` runs once per training step and once per fedtrain frame,
`decode_rows_to_slots` once per server flush, so their host paths are
kept short: the checks of a key run once, in `rows_plan` (payload meta,
leaf shapes and dtypes, output dtype) and `slots_plan` (the same, with
xbuf's and the slot vector's signatures, devices and layouts), and a call
then does one cache lookup and launches; `decode_rows` converts only a
leaf that is not already in the kernel's dtype and layout and allocates
its output."""
from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple, Optional

import torch

from repro_torch.core.payload import KIND_LEAVES, KINDS, Payload
from repro_torch.kernels import _lib
from repro_torch.kernels.decode import ref

MAX_D = 16384
_FLOAT_VALUES = (torch.float32, torch.bfloat16)


def _leaf_widths(m):
    """Last-axis width of each leaf of a payload with meta `m`, in
    KIND_LEAVES order."""
    nw = (m.d + 31) // 32
    return {
        "dense": (m.d,), "slice": (m.k,), "sparse": (m.k, m.k),
        "quant": (m.d, 2), "sparse_quant": (m.k, m.k, 2), "mask": (m.k, nw),
    }[m.kind]


class RowsPlan(NamedTuple):
    """What `decode_rows` needs of one key besides the tensors: the output
    shape and the launch scalars, which leaves the kernel reads, and the
    dtype each leaf must be converted to (None for all when none must)."""

    out_shape: tuple
    rows: int
    d: int
    k: int
    kind_id: int
    vals_bf16: int
    out_bf16: int
    uses_indices: bool
    uses_header: bool
    convert: Optional[tuple]    # (values, indices, header): dtype or None


def _sig(t):
    return None if t is None else (t.shape, t.dtype)


@lru_cache(maxsize=1024)
def rows_plan(meta, dtype, values, indices, header) -> RowsPlan:
    """Check one decode key and lay out its launch; raises on what the
    kernel does not take. `values`, `indices` and `header` are each leaf's
    (shape, dtype), or None where the payload has no such leaf."""
    kind, d = meta.kind, meta.d
    if dtype not in _FLOAT_VALUES:
        raise TypeError(f"decode kernel writes f32/bf16 rows, got {dtype}")
    if d > MAX_D:
        raise ValueError(f"decode kernel rows hold at most {MAX_D}, got {d}")
    sigs = dict(values=values, indices=indices, header=header)
    names = KIND_LEAVES[kind]
    if any(sigs[name] is None for name in names):
        raise ValueError(f"{kind} payload needs leaves {names}")
    lead = tuple(values[0][:-1])
    n = math.prod(lead)
    quant = kind in ("quant", "sparse_quant")
    convert = dict(values=None, indices=None, header=None)
    for name, w in zip(names, _leaf_widths(meta)):
        shape, dt = sigs[name]
        if math.prod(shape) != n * w:
            raise ValueError(f"{kind} {name} of shape {tuple(shape)} is not "
                             f"a ({n}, {w}) block")
        if name == "values" and not quant:
            if not dt.is_floating_point:
                raise TypeError(f"{kind} values must be floating, got {dt}")
            want = dt if dt in _FLOAT_VALUES else torch.float32
        elif name == "header":
            want = torch.float32
        else:
            if dt.is_floating_point:
                raise TypeError(f"{kind} {name} must be integer, got {dt}")
            want = torch.int32
        if dt != want:
            convert[name] = want
    conv = tuple(convert.values())
    vals_dt = convert["values"] or values[1]
    return RowsPlan(lead + (d,), n, d, meta.k, KINDS.index(kind),
                    int(vals_dt == torch.bfloat16),
                    int(dtype == torch.bfloat16), "indices" in names,
                    "header" in names, conv if any(conv) else None)


def decode_rows(p: Payload, *, dtype=None, project=None, backend=None):
    """Any payload (leading dims ..., CUDA leaves) -> dense (..., d) rows in
    `dtype` (f32 or bf16), decoded in f32 and rounded once on the store.
    With `project`, a (d, P) matrix, the f32 rows times it: (..., P) in
    `dtype`, the reference's fused cut-projection epilogue."""
    dtype = dtype or torch.float32
    v, i, h = p.values, p.indices, p.header
    if _lib.resolve_backend(backend, v) == "torch":
        return ref.decode_rows(p, dtype, project)
    if (i is not None and not i.is_cuda) or (h is not None
                                             and not h.is_cuda):
        raise ValueError("decode kernel: payload leaves must all be CUDA "
                         "tensors")
    plan = rows_plan(p.meta, dtype, _sig(v), _sig(i), _sig(h))
    return launch_rows(plan, v, i, h, dtype, project)


def _contiguous(t):
    return t if t.is_contiguous() else t.contiguous()


def launch_rows(plan: RowsPlan, values, indices, header, dtype,
                project: Optional[torch.Tensor] = None):
    """Allocate the output of a checked key (`rows_plan`) and launch
    `decode_rows` (`decode_rows_project` with a projection) on its leaves,
    converting only a leaf that is not in the kernel's dtype and layout.
    The leaves' device is not checked here."""
    if plan.convert is not None:
        values, indices, header = (
            t if c is None else t.to(c)
            for t, c in zip((values, indices, header), plan.convert))
    values = _contiguous(values)
    idx_ptr = hdr_ptr = 0
    if plan.uses_indices:
        idx_ptr = _contiguous(indices).data_ptr()
    if plan.uses_header:
        hdr_ptr = _contiguous(header).data_ptr()
    d = plan.d
    if project is None:
        out = values.new_empty(plan.out_shape, dtype=dtype)
        if plan.rows:
            _lib.launch("decode_rows", values.data_ptr(), plan.vals_bf16,
                        idx_ptr, hdr_ptr, plan.rows, d, plan.kind_id, plan.k,
                        out.data_ptr(), plan.out_bf16,
                        _lib.stream_handle(values))
        return out
    if project.dim() != 2 or project.shape[0] != d \
            or project.device != values.device:
        raise ValueError(f"project must be a ({d}, P) matrix on the "
                         f"leaves' device, got {tuple(project.shape)}")
    w = _contiguous(project.to(torch.float32))
    p_out = w.shape[1]
    scratch = values.new_empty((plan.rows, d), dtype=torch.float32)
    out = values.new_empty(plan.out_shape[:-1] + (p_out,), dtype=dtype)
    if plan.rows:
        _lib.launch("decode_rows_project", values.data_ptr(), plan.vals_bf16,
                    idx_ptr, hdr_ptr, plan.rows, d, plan.kind_id, plan.k,
                    w.data_ptr(), p_out, scratch.data_ptr(), out.data_ptr(),
                    plan.out_bf16, _lib.stream_handle(values))
    return out


class SlotsPlan(NamedTuple):
    """The launch scalars of one `decode_rows_to_slots` key, and which
    leaves the kernel reads."""

    is_bf16: int
    cap1: int
    d: int
    n: int
    kind_id: int
    k: int
    uses_indices: bool
    uses_header: bool


def _slot_sig(t):
    """What `slots_plan` checks of a tensor: shape, dtype, on the card,
    contiguous (None for a missing leaf)."""
    if t is None:
        return None
    return t.shape, t.dtype, t.is_cuda, t.is_contiguous()


@lru_cache(maxsize=1024)
def slots_plan(meta, xbuf, slots, values, indices=None,
               header=None) -> SlotsPlan:
    """Check one `decode_rows_to_slots` key and lay out its launch; raises
    on what the kernel does not take. Each argument after `meta` is a
    tensor's `_slot_sig`, None where the payload has no such leaf."""
    kind, d = meta.kind, meta.d
    shape, dtype, on_card, contiguous = xbuf
    if dtype not in _FLOAT_VALUES:
        raise TypeError(f"decode kernel writes f32/bf16 xbuf, got {dtype}")
    if not (on_card and contiguous) or shape[-1] != d or d > MAX_D:
        raise ValueError(f"xbuf must be a contiguous CUDA (..., {d}) "
                         f"tensor, d <= {MAX_D}")
    s_shape, s_dtype, s_card, s_contiguous = slots
    if not (s_card and s_dtype == torch.int32 and s_contiguous
            and len(s_shape) == 1):
        raise TypeError("slots must be a contiguous int32 CUDA vector")
    n = s_shape[0]
    names = KIND_LEAVES[kind]
    sigs = dict(values=values, indices=indices, header=header)
    if any(sigs[name] is None for name in names):
        raise ValueError(f"{kind} payload needs leaves {names}")
    codes = kind in ("quant", "sparse_quant")
    for name, w in zip(names, _leaf_widths(meta)):
        l_shape, l_dtype, l_card, l_contiguous = sigs[name]
        if not (l_card and l_contiguous and math.prod(l_shape) == n * w):
            raise ValueError(f"{kind} {name} of shape {tuple(l_shape)} is "
                             f"not a contiguous CUDA ({n}, {w}) block")
        want = torch.int32 if name == "indices" or (
            name == "values" and codes) else torch.float32
        if l_dtype != want:
            raise TypeError(f"{kind} {name} dtype {l_dtype}, want {want}")
    return SlotsPlan(int(dtype == torch.bfloat16), math.prod(shape) // d, d,
                     n, KINDS.index(kind), meta.k, "indices" in names,
                     "header" in names)


def decode_rows_to_slots(xbuf: torch.Tensor, p: Payload, slots, *,
                         backend=None):
    """Decode a stacked flush payload (leading dim n = flush rows) straight
    into `xbuf[slots]`, IN PLACE (the reference donates xbuf through the
    kernel; here the kernel writes the rows of the live buffer). xbuf is
    (C + 1, ..., d); untouched rows keep their contents. Returns xbuf."""
    kind = p.meta.kind
    if _lib.resolve_backend(backend, xbuf) == "torch":
        leaves = [getattr(p, n) for n in KIND_LEAVES[kind]]
        return ref.decode_to_slots(xbuf, leaves, slots, kind, p.meta.d)
    v, i, h = p.values, p.indices, p.header
    sig = _slot_sig
    plan = slots_plan(p.meta, sig(xbuf), sig(slots), sig(v), sig(i), sig(h))
    launch_slots(plan, xbuf, slots, v, i, h)
    return xbuf


def launch_slots(plan: SlotsPlan, xbuf, slots, values, indices, header):
    """Launch `decode_to_slots` for a checked key (`slots_plan`); nothing
    of the tensors is checked here."""
    if plan.n:
        _lib.launch("decode_to_slots", xbuf.data_ptr(), plan.is_bf16,
                    plan.cap1, plan.d, slots.data_ptr(), plan.n,
                    plan.kind_id, plan.k, values.data_ptr(),
                    indices.data_ptr() if plan.uses_indices else 0,
                    header.data_ptr() if plan.uses_header else 0,
                    _lib.stream_handle(xbuf))
