"""Plain PyTorch version of the flash-attention kernel: the model's
attention over whole (S, S) logits, the reference's
`kernels/flashattn/ref.py`. The CPU tests run it and `chip_smoke.py`
holds `csrc/flash_attention.cu` against it on the card. As in the
reference, the softmax weights are rounded to v's dtype before P.V, so
bf16 inputs agree with the kernel (which keeps P in f32) only to about
1e-2."""
from __future__ import annotations

import torch


def attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,S,Hq,hd), k/v: (B,S,Hkv,hd) -> (B,S,Hq,hd); f32 softmax."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, S, Hkv, g, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) \
        / (hd ** 0.5)
    pos = torch.arange(S, device=q.device)
    mask = (pos[None, :] <= pos[:, None] if causal
            else torch.ones((S, S), dtype=torch.bool, device=q.device))
    if window:
        mask = mask & (pos[None, :] > pos[:, None] - window)
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    w = torch.exp(logits - logits.amax(-1, keepdim=True))
    w = w / w.sum(-1, keepdim=True)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, S, Hq, hd).to(q.dtype)
