"""Adaptive per-step (k, bits) scheduling for the training wire.

Folds the adaptive feature-wise compression idea of *Communication-Efficient
Split Learning via Adaptive Feature-Wise Compression* (Oh et al., 2023,
arXiv:2307.10805) into the fedtrain runtime as a client-side policy: the
compression intensity of the cut-layer payload is not a fixed hyperparameter
but a function of training progress — dense while representations are still
moving (warmup), sparser as they settle (anneal), and sparser still when the
loss plateaus (the activations carry less new information per step).

Because every wire frame is self-describing (`core.wire` subheaders carry
kind / d / k / bits), the label owner needs **no knowledge of the
schedule** — a per-step k change shows up on the server purely as a
different frame subheader, and the byte accounting measures whatever was
actually sent. The schedule is therefore a pure client-side object whose
state (current k, loss EMA, plateau counters) checkpoints alongside the
client's optimizer state.

Phases of `KScheduler` (each optional):

  1. warmup  — the first `warmup_steps` sync steps send the dense payload
               (k = d, no value quantization): early gradients touch every
               feature, and dense transfer keeps them exact.
  2. anneal  — k moves from `k0` (default d) to the target `k` over
               `anneal_steps`, quantized to at most 8 stages (the
               reference's bound on its per-compressor compile cache; kept
               so both packages send the same k).
  3. adaptive — after the anneal, a loss-EMA plateau detector multiplies k
               by `drop` (floor `k_min`) whenever `patience` sync steps pass
               without a relative EMA improvement of `min_rel_improve`.

The port's copy of the reference's `fedtrain/schedule.py` (numpy only).
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: distinct anneal stages
ANNEAL_STAGES = 8


@dataclasses.dataclass(frozen=True)
class ScheduleSpec:
    """Static schedule configuration; `KScheduler` carries the state."""

    k: int                      # target support after warmup + anneal
    d: int                      # cut width (dense warmup sends k = d)
    bits: int = 0               # value-quantization bits past warmup (0=off)
    warmup_steps: int = 0       # sync steps of dense (k = d) transfer
    anneal_steps: int = 0       # sync steps of k0 -> k anneal after warmup
    k0: int = 0                 # anneal start support (0 -> d)
    k_min: int = 0              # plateau-adaptation floor (0 = no adaptation)
    drop: float = 0.5           # multiplicative k drop on a loss plateau
    patience: int = 25          # sync steps without improvement before a drop
    min_rel_improve: float = 1e-3
    ema: float = 0.9            # loss EMA smoothing

    def __post_init__(self):
        assert 0 < self.k <= self.d
        assert 0 <= self.k_min <= self.k
        assert 0.0 < self.drop < 1.0


class EmaPlateau:
    """EMA-smoothed plateau detector: the "has this signal stopped
    improving?" state machine of `KScheduler` (training loss).

    `observe(x)` folds `x` into an EMA and returns True when `patience`
    consecutive observations have passed without the EMA improving
    (dropping) by a relative `min_rel_improve` over the best seen —
    resetting the baseline to the current EMA so consecutive plateaus can
    fire again. `smooth(x)` updates the EMA without plateau tracking (the
    detector's counters stay frozen: a scheduler at its floor).
    """

    def __init__(self, ema: float, min_rel_improve: float, patience: int):
        self.ema = ema
        self.min_rel_improve = min_rel_improve
        self.patience = patience
        self.value = float("nan")
        self.best = float("inf")
        self.since = 0

    def smooth(self, x: float) -> float:
        self.value = (x if np.isnan(self.value)
                      else self.ema * self.value + (1 - self.ema) * x)
        return self.value

    def observe(self, x: float) -> bool:
        self.smooth(x)
        if self.value < self.best * (1 - self.min_rel_improve):
            self.best = self.value
            self.since = 0
            return False
        self.since += 1
        if self.since >= self.patience:
            self.since = 0
            self.best = self.value
            return True
        return False

    # checkpointable state (numpy scalars, `checkpoint.store`-compatible)

    def state(self) -> dict:
        return {"ema": np.float32(self.value),
                "best": np.float32(self.best),
                "since": np.int32(self.since)}

    def load_state(self, st: dict) -> None:
        self.value = float(st["ema"])
        self.best = float(st["best"])
        self.since = int(st["since"])


class KScheduler:
    """Stateful (k, bits) schedule — one per `TrainingClient`."""

    def __init__(self, spec: ScheduleSpec):
        self.spec = spec
        self.cur_k = spec.k         # plateau-adapted target
        self._plateau = EmaPlateau(spec.ema, spec.min_rel_improve,
                                   spec.patience)

    @property
    def ema_loss(self) -> float:
        return self._plateau.value

    def k_bits(self, step: int) -> tuple:
        """(k, bits) to encode sync step `step` with. k == d means dense."""
        s = self.spec
        if step < s.warmup_steps:
            return s.d, 0
        t = step - s.warmup_steps
        if t < s.anneal_steps:
            k0 = s.k0 or s.d
            stages = min(ANNEAL_STAGES, s.anneal_steps)
            stage = min(stages - 1, t * stages // s.anneal_steps)
            frac = (stage + 1) / stages
            k = int(round(k0 + (self.cur_k - k0) * frac))
            return max(self.cur_k, k), s.bits
        return self.cur_k, s.bits

    def observe(self, loss: float) -> None:
        """Feed back one sync step's loss (from the grad frame)."""
        s = self.spec
        if not s.k_min or s.k_min >= self.cur_k:
            self._plateau.smooth(loss)      # EMA tracks, counters frozen
            return
        if self._plateau.observe(loss):
            self.cur_k = max(s.k_min, int(self.cur_k * s.drop))

    # -- checkpoint state ----------------------------------------------------

    def state(self) -> dict:
        return {"cur_k": np.int32(self.cur_k), **self._plateau.state()}

    def load_state(self, st: dict) -> None:
        self.cur_k = int(st["cur_k"])
        self._plateau.load_state(st)
