"""Error feedback (memory) for cut-layer sparsification, beyond the paper.

The feature owner keeps the residual of what compression dropped and adds
it back before the next compression, so information is delayed rather
than lost:

    c_t = Comp(o_t + e_t);   e_{t+1} = (o_t + e_t) - c_t

In split learning the signal is a per-sample activation, so the residual
of one minibatch would pair with a different minibatch next step; the
closest meaningful analogue is a per-class residual memory (samples of
the same label share an error slot). The port of the reference's
`core/error_feedback.py`; its caveats (docs/beyond-paper.md) hold here.
"""
from __future__ import annotations

import torch

from repro_torch.core import selection


def ef_topk_forward(o, err, labels, k: int, n_slots: int):
    """Per-class error-feedback top-k: one compression step with memory.

    Adds each sample's class residual to its activation, takes the top-k of
    the corrected signal (`selection.topk_mask`: the top-k kernel on the
    card), and scatter-means what was dropped back into the per-class
    slots (slots untouched by this batch keep their residual).

    Args:
      o:       (B, d) cut activations.
      err:     (n_slots, d) residual memory carried across steps; start
               from zeros.
      labels:  (B,) int class ids in [0, n_slots), the slot assignment.
      k:       support size per sample.
      n_slots: number of residual slots (= number of classes).

    Returns (view, mask, new_err): the compressed (B, d) view to send, the
    boolean support mask (apply it to the returning gradient), and the
    updated residual memory.
    """
    labels = labels.long()
    corrected = o + err[labels]
    mask = selection.topk_mask(corrected, k)
    view = corrected * mask.to(o.dtype)
    resid = corrected - view                            # what was dropped
    counts = torch.zeros((n_slots,), dtype=o.dtype, device=o.device)
    counts.index_add_(0, labels, torch.ones_like(labels, dtype=o.dtype))
    sums = torch.zeros((n_slots, o.shape[-1]), dtype=o.dtype,
                       device=o.device).index_add_(0, labels, resid)
    new_err = torch.where(counts[:, None] > 0,
                          sums / torch.clamp(counts[:, None], min=1.0), err)
    return view, mask, new_err
