"""Wrappers of the fused quantize kernel (`csrc/quantize.cu`).

`quantize` takes the plain version (`ref.py`) for a tensor on the CPU or
when `backend="torch"` asks for it; otherwise it launches the kernel or
raises (`_lib.resolve_backend`). Its checks run once per (shape, dtype,
bits) key, in `quant_plan`; a call then allocates the four outputs and
launches. No path of the package runs it yet: the reference exercises its
Pallas counterpart only in its tests, and so does the port (and
`chip_smoke.py` on the card).
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.quant import ref

#: the widest row the kernel takes (the randtopk family's bound)
MAX_D = 16384


class QuantPlan(NamedTuple):
    """The outputs' shapes and the launch scalars of one key."""

    shape: tuple        # x's, the codes' and the values'
    lead: tuple         # lo's and step's
    rows: int
    d: int
    bits: int
    x_bf16: int


@lru_cache(maxsize=1024)
def quant_plan(shape, dtype, bits: int) -> QuantPlan:
    """Check one quantize key; raises on what the kernel does not take."""
    if not 1 <= bits <= 8:
        raise ValueError(f"codes are u8: bits must be in [1, 8], got {bits}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantize kernel takes f32/bf16, got {dtype}")
    d = shape[-1] if len(shape) else 0
    if not 1 <= d <= MAX_D:
        raise ValueError(f"quantize kernel rows hold 1..{MAX_D}, got {d}")
    lead = tuple(shape[:-1])
    return QuantPlan(tuple(shape), lead, math.prod(lead), d, bits,
                     int(dtype == torch.bfloat16))


def quantize(x: torch.Tensor, bits: int = 8, *, backend=None):
    """x (..., d) f32/bf16 -> (codes u8 (..., d), dequantized (..., d) in
    x's dtype, lo f32 (...,), step f32 (...,)); see `ref.quantize`."""
    if not 1 <= bits <= 8:
        raise ValueError(f"codes are u8: bits must be in [1, 8], got {bits}")
    if _lib.resolve_backend(backend, x) == "torch":
        return ref.quantize(x, bits)
    return launch_quant(quant_plan(x.shape, x.dtype, bits), x)


def launch_quant(plan: QuantPlan, x: torch.Tensor):
    """Allocate the outputs of a checked key (`quant_plan`) and launch
    `quantize` on x, made contiguous if it is not."""
    if not x.is_contiguous():
        x = x.contiguous()
    code = x.new_empty(plan.shape, dtype=torch.uint8)
    deq = x.new_empty(plan.shape)
    lo = x.new_empty(plan.lead, dtype=torch.float32)
    step = x.new_empty(plan.lead, dtype=torch.float32)
    if plan.rows:
        _lib.launch("quantize", x.data_ptr(), plan.x_bf16, plan.rows,
                    plan.d, plan.bits, code.data_ptr(), deq.data_ptr(),
                    lo.data_ptr(), step.data_ptr(), _lib.stream_handle(x))
    return code, deq, lo, step


def quantize_dequantize(x: torch.Tensor, bits: int = 8, *, backend=None):
    """The dequantized values alone."""
    return quantize(x, bits, backend=backend)[1]
