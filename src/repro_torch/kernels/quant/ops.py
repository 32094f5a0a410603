"""Wrappers of the fused quantize kernel (`csrc/quantize.cu`).

`quantize` takes the plain version (`ref.py`) for a tensor on the CPU or
when `backend="torch"` asks for it; otherwise it launches the kernel or
raises (`_lib.resolve_backend`). No path of the package runs it yet: the
reference exercises its Pallas counterpart only in its tests, and so
does the port (and `chip_smoke.py` on the card).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.quant import ref

#: the widest row the kernel takes (the randtopk family's bound)
MAX_D = 16384


def quantize(x: torch.Tensor, bits: int = 8, *, backend=None):
    """x (..., d) f32/bf16 -> (codes u8 (..., d), dequantized (..., d) in
    x's dtype, lo f32 (...,), step f32 (...,)); see `ref.quantize`."""
    if not 1 <= bits <= 8:
        raise ValueError(f"codes are u8: bits must be in [1, 8], got {bits}")
    if _lib.resolve_backend(backend, x) == "torch":
        return ref.quantize(x, bits)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantize kernel takes f32/bf16, got {x.dtype}")
    d = x.shape[-1]
    if not 1 <= d <= MAX_D:
        raise ValueError(f"quantize kernel rows hold 1..{MAX_D}, got {d}")
    x2 = x.contiguous().view(-1, d)
    rows = x2.shape[0]
    code = torch.empty(x2.shape, dtype=torch.uint8, device=x.device)
    deq = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    lo = torch.empty((rows,), dtype=torch.float32, device=x.device)
    step = torch.empty((rows,), dtype=torch.float32, device=x.device)
    if rows:
        _lib.launch("quantize", x2.data_ptr(),
                    int(x.dtype == torch.bfloat16), rows, d, bits,
                    code.data_ptr(), deq.data_ptr(), lo.data_ptr(),
                    step.data_ptr(), _lib.stream_handle(x))
    lead = x.shape[:-1]
    return code.view(x.shape), deq.view(x.shape), lo.view(lead), \
        step.view(lead)


def quantize_dequantize(x: torch.Tensor, bits: int = 8, *, backend=None):
    """The dequantized values alone."""
    return quantize(x, bits, backend=backend)[1]
