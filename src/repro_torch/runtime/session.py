"""Per-session state: arena slot + byte accounting from real frames.

`SessionStats` is the measured counterpart of the Table-2 formulas: every
counter is incremented from the `len()` of bytes that actually crossed the
transport, split into payload bytes (the codec's bitstream — what the paper's
compressed sizes describe) and framing bytes (length prefix + headers, a
fixed per-frame cost the analytic rows do not model). Benchmarks compare
`payload_bytes_up / frames_up` against `core.wire` analytic predictions.

The port's copy of the reference's `runtime/session.py`, without the
training-direction, eviction and retransmission state, which are not
ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class SessionStats:
    """Byte/token accounting for one client session (both parties keep one
    and tests assert they agree)."""

    frames_up: int = 0          # payload frames sent client -> server
    payload_bytes_up: int = 0   # codec bitstream bytes only
    header_bytes_up: int = 0    # framing overhead (length prefix + headers)
    frames_down: int = 0        # token frames server -> client
    bytes_down: int = 0         # total down-direction frame bytes
    tokens_out: int = 0         # tokens the client kept (generated, not prompt)
    faults_detected: int = 0    # typed WireErrors caught on this connection
    duplicates: int = 0         # replayed frames deduplicated by seq

    def count_up(self, header_nbytes: int, payload_nbytes: int) -> None:
        self.frames_up += 1
        self.header_bytes_up += header_nbytes
        self.payload_bytes_up += payload_nbytes

    def count_down(self, nbytes: int) -> None:
        self.frames_down += 1
        self.bytes_down += nbytes

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Session:
    """Server-side view of one client: its arena slot + accounting.

    `slot` indexes the server's device-resident `runtime.arena.SlotArena`:
    the session's KV cache and position live in row `slot` of the arena's
    stacked tensors for the session's whole life (assigned at admission,
    reset only when the slot is reclaimed after close). -1 means a slot
    already reclaimed.
    """

    id: int
    slot: int = -1                      # arena row; -1 = reclaimed
    endpoint: Any = None                # server->client reply half
    stats: SessionStats = dataclasses.field(default_factory=SessionStats)
    closed: bool = False
    # stop-and-wait state: the highest seq processed and its cached reply
    # bytes, so a replayed frame is re-acked instead of re-processed
    # (re-processing would double-advance the KV cache)
    last_seq: int = -1
    last_reply: Any = None
