"""Chrome-trace-event JSON export + validation for `obs.trace` tracers.

`chrome_trace(tracer)` turns a tracer's raw events (ts/dur in clock
seconds) into the Chrome trace-event "JSON object format": a dict with a
`traceEvents` list whose entries carry `ph` ("X" complete span, "i"
instant, "M" metadata), microsecond `ts`/`dur`, and `pid`/`tid` track
coordinates. The output loads directly in Perfetto (https://ui.perfetto.dev)
or `chrome://tracing`.

Determinism contract: `dump_json` emits sorted keys, compact separators,
and microsecond stamps rounded to 3 decimals, so a tracer driven by a
`VirtualClock` over a seeded run serializes to byte-identical files across
runs, equal to the reference's file for the same events
(`tests/test_torch_obs.py`).

`validate_chrome_trace` is the schema check CI runs against emitted files;
`check_span_nesting` asserts the laminar-family property (any two spans on
one track are either disjoint or properly nested) that makes the trace
readable as a flame graph.

The port's copy of the reference's `obs/export.py`.
"""
from __future__ import annotations

import json
from typing import List, Tuple

_REQUIRED = ("name", "ph", "ts", "pid", "tid")
_PHASES = ("X", "i", "M")


def chrome_trace(tracer) -> dict:
    """Chrome trace-event object for `tracer` (µs timestamps)."""
    events = []
    for evt in tracer.events():
        out = dict(evt)
        ts = round(out["ts"] * 1e6, 3)
        out["ts"] = ts
        if "dur" in out:
            # derive dur from the ROUNDED endpoints: abutting spans (one's
            # end is the next's start) must stay abutting after rounding,
            # or the nesting check would see phantom sub-µs straddles
            t1 = round((evt["ts"] + out["dur"]) * 1e6, 3)
            out["dur"] = max(0.0, round(t1 - ts, 3))
        events.append(out)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def dump_json(tracer) -> str:
    """Deterministic serialization of `chrome_trace(tracer)`."""
    return json.dumps(chrome_trace(tracer), sort_keys=True,
                      separators=(",", ":")) + "\n"


def write_trace(tracer, path) -> int:
    """Write the Chrome-trace JSON to `path`; returns the event count."""
    text = dump_json(tracer)
    with open(path, "w") as f:
        f.write(text)
    return len(tracer.events())


def validate_chrome_trace(obj) -> List[str]:
    """Schema problems in a parsed Chrome-trace object ([] when clean).

    Checks the subset of the trace-event format this repo emits and
    Perfetto requires: the `traceEvents` wrapper, per-event required
    fields, known phases, numeric non-negative ts/dur, and instant events
    carrying a scope.
    """
    problems: List[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["missing top-level 'traceEvents' object"]
    events = obj["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' is not a list"]
    for i, evt in enumerate(events):
        if not isinstance(evt, dict):
            problems.append(f"event {i}: not an object")
            continue
        missing = [f for f in _REQUIRED if f not in evt]
        if missing:
            problems.append(f"event {i}: missing fields {missing}")
            continue
        ph = evt["ph"]
        if ph not in _PHASES:
            problems.append(f"event {i}: unknown phase {ph!r}")
        if not isinstance(evt["ts"], (int, float)) or evt["ts"] < 0:
            problems.append(f"event {i}: bad ts {evt['ts']!r}")
        if ph == "X":
            dur = evt.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: X event bad dur {dur!r}")
        if ph == "i" and evt.get("s") not in ("t", "p", "g"):
            problems.append(f"event {i}: instant missing scope 's'")
        if ph == "M" and "args" not in evt:
            problems.append(f"event {i}: metadata event missing args")
    return problems


def check_span_nesting(events) -> List[str]:
    """Well-formedness of span intervals per (pid, tid) track.

    Any two "X" spans sharing a track must be disjoint or properly nested
    (the laminar-family property a flame graph needs). Spans in a trace
    arrive unordered, so sort by (start, -end) and sweep with a stack.
    Returns human-readable violations ([] when well-formed).

    Comparisons tolerate half the 0.001 µs export quantum: endpoints are
    quantized by `chrome_trace`, and `ts + dur` on wall-clock-sized µs
    stamps (~1e10) carries float error far below the quantum but above
    exact equality — abutting spans must not read as straddling.
    """
    eps = 5e-4
    tracks: dict = {}
    for evt in events:
        if evt.get("ph") != "X":
            continue
        key = (evt.get("pid", 0), evt.get("tid", 0))
        t0 = evt["ts"]
        tracks.setdefault(key, []).append((t0, t0 + evt.get("dur", 0.0),
                                           evt.get("name", "?")))
    problems: List[str] = []
    for key, spans in sorted(tracks.items()):
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack: List[Tuple[float, float, str]] = []
        for t0, t1, name in spans:
            while stack and stack[-1][1] <= t0 + eps:
                stack.pop()
            if stack and t1 > stack[-1][1] + eps:
                problems.append(
                    f"track {key}: span {name!r} [{t0}, {t1}] straddles "
                    f"{stack[-1][2]!r} [{stack[-1][0]}, {stack[-1][1]}]")
                continue
            stack.append((t0, t1, name))
    return problems
