"""Wrapper of the flash-attention kernels (`csrc/flash_attention.cu`).

`flash_attention` takes the plain version (`ref.py`) for tensors on the
CPU or when `backend="torch"` asks for it; otherwise it launches a kernel
or raises (`_lib.resolve_backend`), chosen by dtype:

  * bf16 -> `flash_attention`, the tensor-core kernel (wgmma, K and V
    tiles by cp.async, softmax in registers);
  * f32  -> `flash_attention_simt`, f32 FMAs from shared memory (TF32
    tensor cores would not meet the f32 tolerance of 3e-5).

Nothing falls back: a call that the dtype's kernel does not take raises.
No path of the package runs it yet: the reference exercises its Pallas
counterpart only in its tests (against its plain version and the model's
attention), and so does the port (and `chip_smoke.py` on the card).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.flashattn import ref

HEAD_DIMS = (32, 64, 128)               # compiled into both kernels
MAX_SMEM = 232448                       # bytes a block can use on an H100
TC_ROWS, TC_KEYS = 128, 64              # the bf16 kernel's own tiles
TC_STAGES = 3                           # ... and its K/V stages


def smem_bytes(bq: int, bk: int, hd: int) -> int:
    """Shared memory of one CTA of the f32 (SIMT) kernel: f32 q tile, K
    tile (rows padded by one), V tile, score tile (padded), output
    accumulator, three row vectors."""
    return 4 * (2 * bq * hd + bk * (2 * hd + 1) + bq * (bk + 1) + 3 * bq)


def tc_smem_bytes(hd: int) -> int:
    """Shared memory of one CTA of the bf16 (tensor-core) kernel: the bf16
    Q tile (TC_ROWS rows), TC_STAGES stages of K and V tiles (TC_KEYS
    rows), head dims below 64 padded to 64, and 1 KB to align the tiles to
    1024 B."""
    hdp = max(hd, 64)
    return 1024 + TC_ROWS * hdp * 2 + TC_STAGES * 2 * TC_KEYS * hdp * 2


def _on_card(*ts) -> bool:
    return all(t.is_cuda for t in ts)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    bq: int = 64, bk: int = 64, backend=None):
    """q: (B, S, Hq, hd); k/v: (B, S, Hkv, hd) -> (B, S, Hq, hd) in q's
    dtype (f32 or bf16), f32 inside. `bq` and `bk` (each capped at S) must
    divide S, as in the reference: that is the callers' contract. They tile
    the f32 kernel; the bf16 kernel keeps its own tiles (TC_ROWS q rows,
    TC_KEYS keys) and masks a ragged last tile. The defaults are 64, not
    the reference's 128: at hd 128 two f32 tiles of 128 rows each pass the
    card's 227 KB of shared memory per block."""
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
        raise TypeError(f"flash kernels take f32 or bf16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash kernels are compiled for head dims "
                         f"{HEAD_DIMS}, got {hd}")
    bf16 = q.dtype == torch.bfloat16
    if not bf16 and smem_bytes(bq, bk, hd) > MAX_SMEM:
        raise ValueError(f"tiles bq={bq}, bk={bk} at hd={hd} need "
                         f"{smem_bytes(bq, bk, hd)} B of shared memory, "
                         f"more than {MAX_SMEM}")
    if not _on_card(k, v):
        raise ValueError("flash kernel needs q, k and v on the card")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if bf16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the bf16 flash kernel copies 16-byte vectors: q, "
                         "k and v must start on a 16-byte boundary")
    out = torch.empty_like(q)
    if not q.numel():
        return out
    if bf16:
        _lib.launch("flash_attention", q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), B, S, Hq, Hkv, hd, int(causal),
                    int(window), float(math.log2(math.e) * hd ** -0.5),
                    out.data_ptr(), _lib.stream_handle(q))
    else:
        _lib.launch("flash_attention_simt", q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), 0, B, S, Hq, Hkv, hd, bq, bk, int(causal),
                    int(window), float(hd ** -0.5), out.data_ptr(),
                    _lib.stream_handle(q))
    return out
