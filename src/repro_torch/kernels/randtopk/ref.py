"""Plain PyTorch versions of the randtopk family.

`topk_mask_threshold` is what `csrc/topk_select.cu` computes; the CPU
tests run it and `chip_smoke.py` holds the kernel against it on the card.
`randtopk_mask` is the plain version of the family's Pallas
`randtopk_mask_kernel` (`repro/kernels/randtopk/kernel.py`), whose CUDA
kernel is not ported yet: it takes its Gumbel noise and pick counts as
data, so the tests hold it exact against the Pallas kernel.
"""
from __future__ import annotations

import torch


def topk_mask_threshold(x: torch.Tensor, k: int):
    """x (..., d) -> (mask bool (..., d), thr f32 (...,)).

    Exactly k elements per row: those with |x| strictly above the kth
    largest magnitude, then those equal to it, admitted left to right (the
    reference's XLA tie rule). `thr` is the kth largest |x|.
    """
    mag = x.abs().float()
    kth = torch.topk(mag, k, dim=-1).values[..., -1:]
    gt = mag > kth
    eq = mag == kth
    need = k - gt.sum(dim=-1, keepdim=True)
    eq_rank = torch.cumsum(eq.to(torch.int32), dim=-1)
    return gt | (eq & (eq_rank <= need)), kth[..., 0]


def select_m_from_pool(scores, pool, m, k: int):
    """Exactly `m` (..., 1) largest Gumbel `scores` inside `pool`, per row:
    the m-th largest in-pool score is the threshold; m == 0 selects none."""
    s = torch.where(pool, scores, torch.full_like(scores, float("-inf")))
    top = torch.topk(s, k, dim=-1).values
    thr = torch.gather(top, -1, torch.clamp(m - 1, 0, k - 1))
    sel = s >= thr
    return torch.where(m > 0, sel, torch.zeros_like(sel))


def randtopk_mask(x, gumbel, m, k: int):
    """Eq. (7) mask with its randomness passed in as data: top-k pool by
    |x|, then k - m Gumbel-race picks inside it and m outside it."""
    is_top, _ = topk_mask_threshold(x, k)
    g = gumbel.float()
    m = m.to(torch.int64)
    return (select_m_from_pool(g, is_top, k - m, k)
            | select_m_from_pool(g, ~is_top, m, k))

