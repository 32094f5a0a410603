"""LR schedules (the reference's `optim/schedule.py`), on Python numbers."""
from __future__ import annotations

import math


def cosine_schedule(base_lr, total_steps, min_frac=0.1):
    def lr(step):
        t = min(step / max(1, total_steps), 1.0)
        return base_lr * (min_frac + (1 - min_frac) * 0.5 *
                          (1 + math.cos(math.pi * t)))
    return lr


def linear_warmup_cosine(base_lr, warmup, total_steps, min_frac=0.05):
    cos = cosine_schedule(base_lr, max(1, total_steps - warmup), min_frac)

    def lr(step):
        if step < warmup:
            return base_lr * step / max(1, warmup)
        return cos(step - warmup)
    return lr
