"""Wrapper of the top-k selection kernel (`csrc/topk_select.cu`).

`topk_mask_threshold` takes the plain version (`ref.py`) for a tensor on
the CPU or when `backend="torch"` asks for it; otherwise it launches the
kernel or raises (`_lib.resolve_backend`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.randtopk import ref

#: the widest row the kernel stages in shared memory (64 KB of f32 keys)
MAX_D = 16384


def topk_mask_threshold(x: torch.Tensor, k: int, *, backend=None):
    """x (..., d) f32/bf16 -> (mask bool (..., d), thr f32 (...,)): exactly
    k largest |x| per row under the XLA tie rule, and the kth |x|."""
    d = x.shape[-1]
    if not 1 <= k <= d:
        raise ValueError(f"top-k needs 1 <= k <= d, got k={k}, d={d}")
    if _lib.resolve_backend(backend, x) == "torch":
        return ref.topk_mask_threshold(x, k)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"topk kernel takes f32/bf16, got {x.dtype}")
    if d > MAX_D:
        raise ValueError(f"topk kernel rows hold at most {MAX_D}, got {d}")
    x2 = x.contiguous().view(-1, d)
    rows = x2.shape[0]
    mask = torch.empty(x2.shape, dtype=torch.bool, device=x.device)
    thr = torch.empty((rows,), dtype=torch.float32, device=x.device)
    if rows:
        _lib.launch("topk_mask_threshold", x2.data_ptr(),
                    int(x.dtype == torch.bfloat16), rows, d, k,
                    mask.data_ptr(), thr.data_ptr(), _lib.stream_handle(x))
    return mask.view(x.shape), thr.view(x.shape[:-1])
