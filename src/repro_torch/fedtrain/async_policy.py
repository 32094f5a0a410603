"""Asynchronous local-update training policy for the feature owner.

The configurable analogue of *Communication and Computation Reduction for
Split Learning using Asynchronous Training* (Chen et al., 2021,
arXiv:2107.09786): instead of crossing the wire every step, a client only
*syncs* — sends the compressed cut activation up and blocks for the grad
frame — every `local_steps` steps, and trains its bottom model against the
**stale** cut gradient in between.

Staleness semantics (normative; docs/protocol.md "Training over the wire"):

  * A sync step caches the dense cut gradient decoded from the grad frame
    (scattered onto the forward support for sparse kinds).
  * Each of the following `local_steps - 1` *local* steps recomputes the
    bottom forward/VJP on its own fresh batch and pulls the cached gradient
    back through it. The stale gradient is per-sample, so pairing it with a
    different batch is an approximation — exactly the trade Chen et al.
    accept — bounded by `local_steps - 1` steps of staleness.
  * The label owner never sees local-step batches: the top model neither
    runs nor updates on them, so BOTH directions' wire traffic and the
    server's compute shrink by ~`local_steps`.

`warmup_sync` forces fully-synchronous training for the first N steps, when
the loss landscape moves too fast for stale gradients to point anywhere
useful. The port's copy of the reference's `fedtrain/async_policy.py`.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AsyncPolicy:
    """When does a client step cross the wire? `local_steps=1` == fully
    synchronous split learning (the paper's setting)."""

    local_steps: int = 1
    warmup_sync: int = 0

    def __post_init__(self):
        assert self.local_steps >= 1 and self.warmup_sync >= 0

    def is_sync(self, step: int) -> bool:
        if step < self.warmup_sync:
            return True
        return (step - self.warmup_sync) % self.local_steps == 0
