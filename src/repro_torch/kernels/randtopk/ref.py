"""Plain PyTorch versions of the randtopk family.

Each is what one CUDA kernel computes; the CPU tests run it and
`chip_smoke.py` holds the kernel against it on the card:

  * `topk_mask_threshold` — `csrc/topk_select.cu`;
  * `randtopk_mask` — `csrc/randtopk_mask.cu` (the reference's
    `randtopk_mask_kernel`), with its Gumbel noise and pick counts passed
    in as data;
  * `scatter_rows` — the `scatter_rows` launcher of `csrc/decode_rows.cu`
    (the reference's `scatter_rows_kernel`).
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
    """Exactly `m` (..., 1) largest `scores` inside `pool`, per row (m at
    most the pool's size and at most k): those strictly above the m-th
    largest in-pool score, then those equal to it, admitted left to right;
    m == 0 selects none. The Pallas kernel's exact-count rule
    (`_count_select`), where the XLA path's `s >= thr` would take every tie."""
    s = torch.where(pool, scores, torch.full_like(scores, float("-inf")))
    top = torch.topk(s, k, dim=-1).values
    kth = torch.gather(top, -1, torch.clamp(m - 1, 0, k - 1))
    gt = pool & (s > kth)
    eq = pool & (s == kth)
    need = m - gt.sum(dim=-1, keepdim=True)
    rank = torch.cumsum(eq.to(torch.int32), dim=-1)
    sel = gt | (eq & (rank <= need))
    return sel & (m > 0)


def randtopk_mask(x, gumbel, m, k: int):
    """Eq. (7) mask with its randomness passed in as data: top-k pool by
    |x|, then k - m Gumbel-race picks inside it and m outside it, m clipped
    to [0, min(k, d - k)]. Exactly k per row."""
    d = x.shape[-1]
    is_top, _ = topk_mask_threshold(x, k)
    g = gumbel.float()
    m = torch.clamp(m.to(torch.int64), 0, min(k, d - k))
    return (select_m_from_pool(g, is_top, k - m, k)
            | select_m_from_pool(g, ~is_top, m, k))


def scatter_rows(values, indices, d: int):
    """(values, indices) (..., k) -> dense (..., d) in the values' dtype:
    duplicate indices sum (in f32), indices outside [0, d) are dropped, as
    in the Pallas compare-and-select accumulate."""
    idx = indices.long()
    ok = (idx >= 0) & (idx < d)
    out = torch.zeros(values.shape[:-1] + (d,), dtype=torch.float32,
                      device=values.device)
    out.scatter_add_(-1, torch.where(ok, idx, 0),
                     torch.where(ok, values.float(), 0.0))
    return out.to(values.dtype)
