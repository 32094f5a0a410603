"""Deterministic synthetic token pipeline (the reference's
`data/pipeline.py`): `next_batch(step)` is a function of (seed, step),
drawn from a `torch.Generator` on the batch's device, so the tokens never
cross from the host. The numbers differ from the reference's threefry
draws; the tests hand both packages the same numpy batch instead.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.models.config import ArchConfig


def make_lm_batch(generator: torch.Generator, cfg: ArchConfig, batch: int,
                  seq: int, device=None) -> Dict:
    """Markov-ish synthetic LM data: tokens with learnable local structure
    (each position repeats the previous token with probability 0.7); the
    vlm's batch adds `patches` (batch, n_image_tokens, d) and whisper's
    `frames` (batch, n_frames, d), N(0, 1) * 0.02 in the activation dtype
    (the stubbed vision and audio front ends)."""
    base = torch.randint(0, cfg.vocab, (batch, seq), generator=generator,
                         device=device, dtype=torch.int32)
    coin = torch.rand((batch, seq), generator=generator, device=device) < 0.7
    shifted = torch.roll(base, 1, dims=1)
    tokens = torch.where(coin, shifted, base)
    labels = torch.roll(tokens, -1, dims=1)
    out = {"tokens": tokens, "labels": labels}
    side = {"vlm": ("patches", cfg.n_image_tokens),
            "audio": ("frames", cfg.n_frames)}.get(cfg.family)
    if side:
        out[side[0]] = torch.randn((batch, side[1], cfg.d_model),
                                   generator=generator, device=device,
                                   dtype=cfg.adtype()) * 0.02
    return out


@dataclasses.dataclass
class TokenPipeline:
    cfg: ArchConfig
    batch: int
    seq: int
    seed: int = 0
    device: str = "cuda"

    def next_batch(self, step: int) -> Dict:
        gen = torch.Generator(device=self.device).manual_seed(
            self.seed * 1_000_003 + step)
        return make_lm_batch(gen, self.cfg, self.batch, self.seq,
                             device=self.device)
