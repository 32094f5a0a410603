"""Wrappers of the randtopk family's kernels: top-k selection
(`csrc/topk_select.cu`), the Eq. (7) randomized mask
(`csrc/randtopk_mask.cu`) and the sparse scatter (`scatter_rows` in
`csrc/decode_rows.cu`).

Each takes the plain version (`ref.py`) for a tensor on the CPU or when
`backend="torch"` asks for it; otherwise it launches its kernel or raises
(`_lib.resolve_backend`). The top-k wrapper's checks run once per key
(`topk_plan`). The serving client's top-k runs inside the fused encode
instead (`encode.ops.encode_sections`, `select=True`).
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.randtopk import ref

#: the widest row the kernels stage in shared memory (64 KB of f32 keys)
MAX_D = 16384


def _check_rows(x: torch.Tensor, what: str, dtypes) -> None:
    if x.dtype not in dtypes:
        raise TypeError(f"{what} kernel takes {dtypes}, got {x.dtype}")
    if x.shape[-1] > MAX_D:
        raise ValueError(f"{what} kernel rows hold at most {MAX_D}, got "
                         f"{x.shape[-1]}")


_FLOATS = (torch.float32, torch.bfloat16)


class TopkPlan(NamedTuple):
    """What `topk_mask_threshold` needs of one key besides the tensor."""

    rows: int
    d: int
    x_bf16: int


@lru_cache(maxsize=1024)
def topk_plan(shape, dtype, k: int) -> TopkPlan:
    """Check one top-k key (x's shape and dtype, k) once; raises on what
    the kernel does not take."""
    d = shape[-1]
    if not 1 <= k <= d:
        raise ValueError(f"top-k needs 1 <= k <= d, got k={k}, d={d}")
    if dtype not in _FLOATS:
        raise TypeError(f"topk kernel takes {_FLOATS}, got {dtype}")
    if d > MAX_D:
        raise ValueError(f"topk kernel rows hold at most {MAX_D}, got {d}")
    return TopkPlan(math.prod(shape[:-1]), d, int(dtype == torch.bfloat16))


def topk_mask_threshold(x: torch.Tensor, k: int, *, backend=None):
    """x (..., d) f32/bf16 -> (mask bool (..., d), thr f32 (...,)): exactly
    k largest |x| per row under the XLA tie rule, and the kth |x|."""
    if _lib.resolve_backend(backend, x) == "torch":
        d = x.shape[-1]
        if not 1 <= k <= d:
            raise ValueError(f"top-k needs 1 <= k <= d, got k={k}, d={d}")
        return ref.topk_mask_threshold(x, k)
    plan = topk_plan(x.shape, x.dtype, k)
    if not x.is_contiguous():
        x = x.contiguous()
    mask = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    thr = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    if plan.rows:
        _lib.launch("topk_mask_threshold", x.data_ptr(), plan.x_bf16,
                    plan.rows, plan.d, k, mask.data_ptr(), thr.data_ptr(),
                    _lib.stream_handle(x))
    return mask, thr


def randtopk_mask(x: torch.Tensor, gumbel: torch.Tensor, m: torch.Tensor,
                  k: int, *, backend=None):
    """Eq. (7) mask, exactly k per row: x (..., d) f32/bf16, gumbel (..., d)
    i.i.d. Gumbel noise, m (..., 1) non-top-k pick counts (clipped to
    [0, min(k, d - k)]) -> bool (..., d). The noise and counts are drawn by
    the caller (`core.selection.randtopk_mask`) and cross as data."""
    d = x.shape[-1]
    if not 1 <= k <= d:
        raise ValueError(f"randtopk needs 1 <= k <= d, got k={k}, d={d}")
    if gumbel.shape != x.shape or m.numel() * d != x.numel():
        raise ValueError(f"gumbel {tuple(gumbel.shape)} / m "
                         f"{tuple(m.shape)} do not match x {tuple(x.shape)}")
    if _lib.resolve_backend(backend, x) == "torch":
        return ref.randtopk_mask(x, gumbel, m, k)
    _check_rows(x, "randtopk", _FLOATS)
    if gumbel.device != x.device or m.device != x.device:
        raise ValueError("randtopk kernel needs gumbel and m on x's device")
    x2 = x.contiguous().view(-1, d)
    g2 = gumbel.to(torch.float32).contiguous().view(-1, d)
    m2 = m.to(torch.int32).contiguous().view(-1)
    rows = x2.shape[0]
    mask = torch.empty(x2.shape, dtype=torch.bool, device=x.device)
    if rows:
        _lib.launch("randtopk_mask", x2.data_ptr(),
                    int(x.dtype == torch.bfloat16), g2.data_ptr(),
                    m2.data_ptr(), rows, d, k, mask.data_ptr(),
                    _lib.stream_handle(x))
    return mask.view(x.shape)


def scatter_rows(values: torch.Tensor, indices: torch.Tensor, d: int, *,
                 backend=None):
    """Sparse (values, indices) (..., k) -> dense (..., d) in the values'
    dtype (f32/bf16): zeros off the support, duplicate indices summed in
    f32, indices outside [0, d) dropped.

    The kernel's launch path runs once per training step's backward, and
    its host time is most of the call: the checks read each attribute
    once, and the conversions and views that would be no-ops (2-D,
    contiguous, int32 indices) are skipped."""
    shape = values.shape
    if indices.shape != shape:
        raise ValueError(f"indices {tuple(indices.shape)} do not match "
                         f"values {tuple(shape)}")
    if _lib.resolve_backend(backend, values) == "torch":
        return ref.scatter_rows(values, indices, d)
    dtype = values.dtype
    if dtype not in _FLOATS:
        raise TypeError(f"scatter_rows kernel takes {_FLOATS}, got {dtype}")
    k = shape[-1]
    if k > MAX_D or d > MAX_D:
        raise ValueError(f"scatter_rows kernel rows hold at most {MAX_D}, "
                         f"got k = {k}, d = {d}")
    if not indices.is_cuda:
        raise ValueError("scatter_rows kernel needs indices on the card")
    flat = len(shape) == 2
    v2 = values if flat and values.is_contiguous() else \
        values.contiguous().view(-1, k)
    i2 = indices if flat and indices.dtype == torch.int32 and \
        indices.is_contiguous() else \
        indices.to(torch.int32).contiguous().view(-1, k)
    rows = v2.shape[0]
    out = v2.new_empty((rows, d))
    if rows:
        _lib.launch("scatter_rows", v2.data_ptr(),
                    int(dtype == torch.bfloat16), i2.data_ptr(), rows, d, k,
                    out.data_ptr(), _lib.stream_handle(v2))
    return out if flat else out.view(shape[:-1] + (d,))
