"""Serving metrics — streaming quantiles and latency aggregation.

An SLO harness watching millions of token round trips cannot keep every
sample to sort at the end; `P2Quantile` is the classic P² algorithm (Jain &
Chlamtac, CACM 1985): five markers track (min, q/2, q, (1+q)/2, max)
rank positions and are nudged by parabolic (fallback linear) interpolation
as each observation arrives — O(1) memory and time per sample, no buckets
to pre-size. `LatencyStats` runs both the exact (sorted-at-the-end) and the
streaming estimators side by side, so the harness reports exact percentiles
next to the streaming estimate (`tests/test_torch_obs.py` holds both to
the reference's, exactly, on the same samples).
When sample counts make the exact list unaffordable, construct with
`keep_samples=False` (streaming-only from the start) or set
`max_exact_samples=N` to demote automatically once N samples have been
seen — the loadgen harness opts into the latter above its configured
threshold. In streaming-only mode `report()` fills the `pXX_ms` keys from
the P² markers, so consumers (`evaluate_slo`, the bench emitters) read the
same schema either way.

The port's copy of the reference's `runtime/metrics.py`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


class P2Quantile:
    """Streaming estimate of the `q`-quantile via the P² algorithm.

    Exact (interpolated, numpy `linear` method) below 5 observations;
    afterwards the five-marker invariant holds h[0] <= .. <= h[4] with
    h[0]/h[4] the running min/max, so the estimate is always inside the
    observed range.
    """

    def __init__(self, q: float):
        assert 0.0 < q < 1.0
        self.q = q
        self.count = 0
        self._h: List[float] = []           # marker heights
        self._n = [0.0, 1.0, 2.0, 3.0, 4.0]     # marker positions (0-based)
        self._want = [0.0, 2 * q, 4 * q, 2 + 2 * q, 4.0]  # desired positions
        self._dwant = [0.0, q / 2, q, (1 + q) / 2, 1.0]   # per-sample drift

    def add(self, x: float) -> None:
        x = float(x)
        self.count += 1
        if self.count <= 5:
            self._h.append(x)
            if self.count == 5:
                self._h.sort()
            return
        h, n = self._h, self._n
        # locate the cell k with h[k] <= x < h[k+1], extending the extremes
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = max(h[4], x)
            k = 3
        else:
            k = max(i for i in range(4) if h[i] <= x)
        for i in range(k + 1, 5):
            n[i] += 1
        for i in range(5):
            self._want[i] += self._dwant[i]
        # nudge the three interior markers toward their desired positions
        for i in (1, 2, 3):
            d = self._want[i] - n[i]
            if ((d >= 1 and n[i + 1] - n[i] > 1)
                    or (d <= -1 and n[i - 1] - n[i] < -1)):
                d = 1.0 if d > 0 else -1.0
                cand = self._parabolic(i, d)
                if not (h[i - 1] < cand < h[i + 1]):
                    cand = self._linear(i, d)
                h[i] = cand
                n[i] += d

    def _parabolic(self, i: int, d: float) -> float:
        h, n = self._h, self._n
        return h[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (h[i + 1] - h[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - d) * (h[i] - h[i - 1]) / (n[i] - n[i - 1]))

    def _linear(self, i: int, d: float) -> float:
        h, n = self._h, self._n
        j = i + int(d)
        return h[i] + d * (h[j] - h[i]) / (n[j] - n[i])

    def value(self) -> float:
        if self.count == 0:
            return float("nan")
        if self.count < 5:
            return float(np.quantile(np.asarray(self._h, float), self.q))
        return self._h[2]


class LatencyStats:
    """Exact + streaming latency percentiles over one traffic run.

    `keep_samples=False` drops the unbounded exact-sample list up front;
    `max_exact_samples=N` keeps exact reporting until N samples have
    arrived, then discards the list and continues streaming-only. Count,
    mean, and max stay exact in every mode (O(1) accumulators).
    """

    QS = (0.50, 0.95, 0.99)

    def __init__(self, keep_samples: bool = True,
                 max_exact_samples: Optional[int] = None):
        self.samples: List[float] = []
        self.keep_samples = bool(keep_samples)
        self.max_exact_samples = max_exact_samples
        self._n = 0
        self._sum = 0.0
        self._max = float("-inf")
        self._p2: Dict[float, P2Quantile] = {q: P2Quantile(q)
                                             for q in self.QS}

    def add(self, seconds: float) -> None:
        seconds = float(seconds)
        self._n += 1
        self._sum += seconds
        if seconds > self._max:
            self._max = seconds
        if self.keep_samples:
            self.samples.append(seconds)
            if (self.max_exact_samples is not None
                    and self._n >= self.max_exact_samples):
                # past the affordability threshold: go streaming-only
                self.keep_samples = False
                self.samples = []
        for est in self._p2.values():
            est.add(seconds)

    def __len__(self) -> int:
        return self._n

    @property
    def streaming_only(self) -> bool:
        """True once the exact-sample list has been dropped."""
        return not self.keep_samples

    def exact(self, q: float) -> float:
        """Exact quantile; falls back to the P² estimate once the sample
        list has been dropped (streaming-only mode)."""
        if self.streaming_only:
            return self.streaming(q)
        if not self.samples:
            return float("nan")
        return float(np.quantile(np.asarray(self.samples), q))

    def streaming(self, q: float) -> float:
        return self._p2[q].value()

    def report(self) -> dict:
        """Percentiles in milliseconds: `pXX_ms` (exact, or the P² value
        in streaming-only mode) next to the always-streaming `p2_pXX_ms`."""
        out = {"n": self._n,
               "mean_ms": (self._sum / self._n * 1e3
                           if self._n else float("nan")),
               "max_ms": self._max * 1e3 if self._n else float("nan"),
               "streaming_only": self.streaming_only}
        for q in self.QS:
            tag = f"p{int(round(q * 100)):02d}"
            out[f"{tag}_ms"] = self.exact(q) * 1e3
            out[f"p2_{tag}_ms"] = self.streaming(q) * 1e3
        return out


def merged_percentiles(groups: Sequence[Sequence[float]]) -> dict:
    """Exact pooled percentiles across per-session latency lists.

    Both branches return the same `pXX_ms`-style keys as
    `LatencyStats.report()`; an all-empty input yields NaN values, not a
    differently-keyed dict.
    """
    tags = {q: f"p{int(round(q * 100)):02d}_ms" for q in LatencyStats.QS}
    pooled = np.concatenate([np.asarray(g, float) for g in groups if len(g)]
                            or [np.asarray([], float)])
    if pooled.size == 0:
        return {tags[q]: float("nan") for q in LatencyStats.QS}
    return {tags[q]: float(np.quantile(pooled, q)) * 1e3
            for q in LatencyStats.QS}
