"""Per-session state: arena slot + byte accounting from real frames.

`SessionStats` is the measured counterpart of the Table-2 formulas: every
counter is incremented from the `len()` of bytes that actually crossed the
transport, split into payload bytes (the codec's bitstream — what the paper's
compressed sizes describe) and framing bytes (length prefix + headers, a
fixed per-frame cost the analytic rows do not model). Benchmarks compare
`payload_bytes_up / frames_up` against `core.wire` analytic predictions.

The port's copy of the reference's `runtime/session.py`.
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
    frames_down: int = 0        # token/grad frames server -> client
    bytes_down: int = 0         # total down-direction frame bytes
    payload_bytes_down: int = 0  # grad-frame codec bitstream bytes (training)
    header_bytes_down: int = 0   # grad-frame framing bytes (training)
    tokens_out: int = 0         # tokens the client kept (generated, not prompt)
    # fault counters — all zero on a clean wire; under injected chaos they
    # are the measured recovery record (engine.run_streaming aggregates
    # them)
    faults_detected: int = 0    # typed WireErrors caught on this connection
    duplicates: int = 0         # replayed frames deduplicated by seq
    replays: int = 0            # retransmissions sent after timeout/error
    reconnects: int = 0         # fresh connections opened to resume

    @property
    def bytes_up(self) -> int:
        return self.payload_bytes_up + self.header_bytes_up

    @property
    def payload_bytes_per_frame(self) -> float:
        return self.payload_bytes_up / max(1, self.frames_up)

    def count_up(self, header_nbytes: int, payload_nbytes: int) -> None:
        self.frames_up += 1
        self.header_bytes_up += header_nbytes
        self.payload_bytes_up += payload_nbytes

    def count_down(self, nbytes: int) -> None:
        self.frames_down += 1
        self.bytes_down += nbytes

    def count_down_frame(self, header_nbytes: int,
                         payload_nbytes: int) -> None:
        """A down-direction frame with the payload/framing split: the
        training grad frames, whose payload bytes the Table-2 bwd column
        models (serving token replies keep the aggregate `count_down`)."""
        self.frames_down += 1
        self.header_bytes_down += header_nbytes
        self.payload_bytes_down += payload_nbytes
        self.bytes_down += header_nbytes + payload_nbytes

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Session:
    """Server-side view of one client: its arena slot + accounting.

    `slot` indexes the server's device-resident `runtime.arena.SlotArena`:
    the session's KV cache and position live in row `slot` of the arena's
    stacked tensors while the session is resident (assigned at admission,
    surviving reconnects, reset when the slot is reclaimed after close).
    -1 means no device row: a training session, a reclaimed slot, or an
    evicted session whose row is on the host.
    """

    id: int
    slot: int = -1                      # arena row; -1 = reclaimed
    endpoint: Any = None                # server->client reply half
    stats: SessionStats = dataclasses.field(default_factory=SessionStats)
    closed: bool = False
    # slot-lifecycle state: `pending` counts frames enqueued but not yet
    # processed — a session is only LRU-evictable at pending == 0, so an
    # in-flight frame never loses its device row; `last_active` is the
    # serve-clock time of admission / last processed frame (the LRU key);
    # `host_state` holds the evicted KV row on the host (None while
    # resident; the server's _EVICTING sentinel between the eviction
    # decision and the serve loop's fetch)
    pending: int = 0
    last_active: float = 0.0
    host_state: Any = None
    # stop-and-wait state: the highest seq processed and its cached reply
    # bytes, so a replayed frame is re-acked instead of re-processed
    # (re-processing would double-advance the KV cache)
    last_seq: int = -1
    last_reply: Any = None
    last_reply_header: int = 0          # framing bytes of `last_reply`
