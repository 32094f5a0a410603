"""Congestion-adaptive (k, bits) QoS control for the serving wire.

The serving-side sibling of `fedtrain.schedule.KScheduler`: where the
training scheduler tightens compression as the *loss* plateaus, this
controller tightens it as the *server* congests — the paper's accuracy-
per-byte argument applied dynamically. Randomized top-k keeps the best
fidelity at any byte budget, so when queue depth or deadline slack says
bytes are scarce, the right move is to shed bytes by walking down a
(k, bits) ladder within declared floors, not to reject sessions or blow
the latency SLO (after Oh et al. 2023, adaptive feature-wise compression,
PAPERS.md).

Mechanics (per session, observed once per token reply):

  * the ladder is built once from `QoSSpec`: (k, bits) at the top, k
    halving toward `k_floor`, then a final rung at `bits_floor` when value
    quantization has room to shrink. A bounded ladder keeps the client's
    per-compressor jit cache small — the same reason `KScheduler` caps
    its anneal at 8 stages;
  * tighten one rung immediately when congestion is *acute*: observed
    queue depth at/above `high_depth`, or reply latency past
    `deadline_s`. Both signals are things a real client can see (depth is
    piggybacked here by the harness; latency it measures itself);
  * tighten also when pressure is *chronic*: an `EmaPlateau` (the exact
    state machine `KScheduler` uses, `fedtrain.schedule`) watches the
    smoothed queue depth and fires when it stops improving while sitting
    above `low_depth` — catching sustained saturation that never crosses
    the acute thresholds;
  * relax one rung only after `patience` consecutive healthy
    observations (depth at/below `low_depth` AND latency under half the
    deadline) — tighten-fast/relax-slow hysteresis so one calm flush in
    the middle of a burst cannot bounce the fleet back up the ladder;
  * `cooldown` observations must pass between any two moves, bounding
    the rung-change (and therefore client recompile) rate.

State (`state()`/`load_state()`) round-trips through `checkpoint.store`
npz files exactly like the training scheduler's, so a serving session can
resume mid-burst at its adapted rung.

The port's copy of the reference's `runtime/qos.py`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.fedtrain.schedule import EmaPlateau
from repro_torch.obs.registry import DEFAULT_REGISTRY
from repro_torch.obs.trace import (EVT_QOS_TRANSITION, NULL_TRACER,
                                   session_tid)


@dataclasses.dataclass(frozen=True)
class QoSSpec:
    """Declared QoS envelope: the compression a session starts at, the
    floors it may be tightened to, and the congestion thresholds."""

    k: int                      # top-of-ladder support (the fleet's spec)
    d: int                      # cut width (frames are self-describing,
    #                             but the ladder must respect k <= d)
    bits: int = 0               # top-of-ladder value-quantization (0 = f32)
    k_floor: int = 4            # never tighten support below this
    bits_floor: int = 0         # extra rung at this bit width (0 = none)
    high_depth: int = 16        # acute congestion: queue depth at/above
    low_depth: int = 2          # healthy: queue depth at/below
    deadline_s: float = 0.25    # acute congestion: token latency beyond
    patience: int = 8           # healthy observations before relaxing
    cooldown: int = 2           # min observations between rung moves
    ema: float = 0.7            # chronic-pressure EMA smoothing
    min_rel_improve: float = 0.05
    sustain: int = 12           # chronic-pressure plateau patience

    def __post_init__(self):
        assert 0 < self.k_floor <= self.k <= self.d
        assert self.bits_floor == 0 or 0 < self.bits_floor <= self.bits
        assert 0 <= self.low_depth < self.high_depth
        assert self.deadline_s > 0 and self.cooldown >= 0

    def ladder(self) -> List[Tuple[int, int]]:
        """(k, bits) rungs, least to most compressed. Bounded: O(log2
        k/k_floor) + 1, so the per-spec jitted bottom steps stay few."""
        rungs = [(self.k, self.bits)]
        k = self.k
        while k > self.k_floor:
            k = max(self.k_floor, k // 2)
            rungs.append((k, self.bits))
        if self.bits_floor and self.bits_floor < self.bits:
            rungs.append((self.k_floor, self.bits_floor))
        return rungs


def compressor_spec(k: int, bits: int) -> str:
    """`core.compressors.make_compressor` spec string for one rung."""
    if bits:
        return f"randtopk_quant:k={k},bits={bits}"
    return f"randtopk:k={k}"


class QoSController:
    """Per-session (k, bits) ladder position, driven by congestion.

    Every rung move emits a `qos.transition` instant on the session's
    trace track (when a tracer is attached) and bumps
    `qos_transitions_total{direction=tighten|relax}` in the registry, so a
    run trace *explains* each move: the instant's args carry the rung
    endpoints, the depth/latency observation that forced it, and whether
    the trigger was acute or chronic.
    """

    def __init__(self, spec: QoSSpec, *, tracer=NULL_TRACER,
                 registry=DEFAULT_REGISTRY, sid: Optional[int] = None):
        self.spec = spec
        self.levels = spec.ladder()
        self.level = 0              # index into `levels` (0 = declared top)
        self.healthy = 0            # consecutive healthy observations
        self.cool = 0               # observations since the last move
        self.switches = 0           # total rung moves (bench/report)
        self._pressure = EmaPlateau(spec.ema, spec.min_rel_improve,
                                    spec.sustain)
        self.tracer = tracer
        self.registry = registry
        self.sid = sid              # trace track / labels (None = unbound)

    def _record_move(self, frm: int, direction: str, *, queue_depth: int,
                     latency_s: float, reason: str) -> None:
        self.registry.counter("qos_transitions_total",
                              direction=direction).inc()
        if self.tracer.enabled:
            k, bits = self.levels[self.level]
            self.tracer.instant(
                EVT_QOS_TRANSITION,
                tid=session_tid(self.sid) if self.sid is not None else None,
                sid=self.sid, frm=frm, to=self.level, k=k, bits=bits,
                direction=direction, reason=reason,
                queue_depth=queue_depth, latency_ms=latency_s * 1e3)

    def k_bits(self) -> Tuple[int, int]:
        return self.levels[self.level]

    def compressor_spec(self) -> str:
        return compressor_spec(*self.k_bits())

    def observe(self, queue_depth: int, latency_s: float) -> None:
        """Feed back one token reply's view of the server: the queue depth
        its flush saw and the request->token round-trip it measured."""
        s = self.spec
        self.cool += 1
        acute = queue_depth >= s.high_depth or latency_s > s.deadline_s
        # chronic: the smoothed depth has stopped improving above low_depth
        chronic = (self._pressure.observe(float(queue_depth))
                   and self._pressure.value > s.low_depth)
        if acute or chronic:
            self.healthy = 0
            if self.cool >= s.cooldown and self.level + 1 < len(self.levels):
                self.level += 1
                self.switches += 1
                self.cool = 0
                self._record_move(self.level - 1, "tighten",
                                  queue_depth=queue_depth,
                                  latency_s=latency_s,
                                  reason="acute" if acute else "chronic")
            return
        if queue_depth <= s.low_depth and latency_s <= s.deadline_s / 2:
            self.healthy += 1
            if (self.healthy >= s.patience and self.cool >= s.cooldown
                    and self.level > 0):
                self.level -= 1
                self.switches += 1
                self.healthy = 0
                self.cool = 0
                self._record_move(self.level + 1, "relax",
                                  queue_depth=queue_depth,
                                  latency_s=latency_s, reason="healthy")
        else:
            self.healthy = 0

    # -- checkpoint state ----------------------------------------------------

    def state(self) -> dict:
        """Numpy-scalar dict, `checkpoint.store.save`-compatible (the same
        convention as `KScheduler.state`)."""
        return {"level": np.int32(self.level),
                "healthy": np.int32(self.healthy),
                "cool": np.int32(self.cool),
                "switches": np.int32(self.switches),
                **{f"pressure_{k}": v
                   for k, v in self._pressure.state().items()}}

    def load_state(self, st: dict) -> None:
        self.level = min(int(st["level"]), len(self.levels) - 1)
        self.healthy = int(st["healthy"])
        self.cool = int(st["cool"])
        self.switches = int(st["switches"])
        self._pressure.load_state(
            {k[len("pressure_"):]: v for k, v in st.items()
             if k.startswith("pressure_")})
