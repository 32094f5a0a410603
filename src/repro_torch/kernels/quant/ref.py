"""Plain PyTorch version of the fused quantize kernel (Eq. 2), what
`csrc/quantize.cu` computes: the reference's `kernels/quant/ref.py`. The
CPU tests run it and `chip_smoke.py` holds the kernel against it on the
card."""
from __future__ import annotations

import torch


def quantize(x: torch.Tensor, bits: int = 8):
    """x (..., d) f32/bf16 -> (codes u8 (..., d), dequantized (..., d) in
    x's dtype, lo f32 (...,), step f32 (...,)).

    Per row: lo = min, hi = max, step = (hi - lo) / 2**bits (1.0 when not
    positive), code = clip(floor((x - lo) / step), 0, 2**bits - 1),
    dequantized = lo + (code + 0.5) * step; each operation rounded on its
    own. A row whose min is a zero and that holds a -0.0 gets lo = -0.0,
    as XLA's min orders -0.0 below +0.0 (torch's may return either)."""
    xf = x.float()
    lo = xf.min(dim=-1, keepdim=True).values
    lo = torch.where((lo == 0) & torch.signbit(xf).any(-1, keepdim=True),
                     torch.full_like(lo, -0.0), lo)
    hi = xf.max(dim=-1, keepdim=True).values
    n_bins = 2 ** bits
    step = (hi - lo) / n_bins
    step = torch.where(step <= 0, torch.ones_like(step), step)
    code = torch.clamp(torch.floor((xf - lo) / step), 0, n_bins - 1)
    deq = (lo + (code + 0.5) * step).to(x.dtype)
    return code.to(torch.uint8), deq, lo[..., 0], step[..., 0]
