"""Wrapper of the flash-attention kernel (`csrc/flash_attention.cu`).

`flash_attention` takes the plain version (`ref.py`) for tensors on the
CPU or when `backend="torch"` asks for it; otherwise it launches the
kernel or raises (`_lib.resolve_backend`). No path of the package runs
it yet: the reference exercises its Pallas counterpart only in its tests
(against its plain version and the model's attention), and so does the
port (and `chip_smoke.py` on the card).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.flashattn import ref

HEAD_DIMS = (32, 64, 128)               # compiled into the kernel
MAX_SMEM = 232448                       # bytes a block can use on an H100


def smem_bytes(bq: int, bk: int, hd: int) -> int:
    """Shared memory of one CTA: f32 q tile, K tile (rows padded by one),
    V tile, score tile (padded), output accumulator, three row vectors."""
    return 4 * (2 * bq * hd + bk * (2 * hd + 1) + bq * (bk + 1) + 3 * bq)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    bq: int = 64, bk: int = 64, backend=None):
    """q: (B, S, Hq, hd); k/v: (B, S, Hkv, hd) -> (B, S, Hq, hd) in q's
    dtype (f32 or bf16), f32 inside. `bq` and `bk` tile the queries and
    keys (each capped at S) and must divide S, as in the reference. The
    defaults are 64, not the reference's 128: at hd 128 two f32 tiles of
    128 rows each pass the card's 227 KB of shared memory per block."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"q (B,S,Hq,hd) and k, v (B,S,Hkv,hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd \
            or Hq % Hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    bq, bk = min(bq, S), min(bk, S)
    if S % bq or S % bk:
        raise ValueError(f"S = {S} must be a multiple of bq = {bq} and "
                         f"bk = {bk} (pad upstream)")
    if _lib.resolve_backend(backend, q) == "torch":
        return ref.attention(q, k, v, causal=causal, window=window)
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes f32 or bf16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash kernel is compiled for head dims "
                         f"{HEAD_DIMS}, got {hd}")
    if smem_bytes(bq, bk, hd) > MAX_SMEM:
        raise ValueError(f"tiles bq={bq}, bk={bk} at hd={hd} need "
                         f"{smem_bytes(bq, bk, hd)} B of shared memory, "
                         f"more than {MAX_SMEM}")
    if not (k.is_cuda and v.is_cuda):
        raise ValueError("flash kernel needs q, k and v on the card")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if q.numel():
        _lib.launch("flash_attention", q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), int(q.dtype == torch.bfloat16), B, S, Hq,
                    Hkv, hd, bq, bk, int(causal), int(window),
                    float(hd ** -0.5), out.data_ptr(), _lib.stream_handle(q))
    return out
