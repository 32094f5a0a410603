"""In-process byte transport — a simulated duplex socket carrying frames.

Both directions move *bytes*, not arrays: the sender serializes a frame with
`core.wire` and the receiver reassembles it through a `wire.FrameReader`, so
every measured size in the runtime is the length of a real byte string that
crossed a queue. Swapping this for a TCP socket changes only this module —
client, server, and accounting already speak length-prefixed frames and
tolerate arbitrary chunk boundaries.
"""
from __future__ import annotations

import queue
from typing import Optional

from repro_torch.core import wire


class _BytePipe:
    """One direction: an unbounded thread-safe stream of byte chunks."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue()

    def send(self, data: bytes) -> int:
        self._q.put(bytes(data))
        return len(data)

    def recv(self, timeout: Optional[float] = None) -> Optional[bytes]:
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None


class Endpoint:
    """One party's view of a duplex channel: send bytes, receive frames."""

    def __init__(self, out_pipe: _BytePipe, in_pipe: _BytePipe):
        self._out = out_pipe
        self._in = in_pipe
        self._reader = wire.FrameReader()
        self._pending: list = []
        self.closed = False

    def close(self) -> None:
        """Mark this end closed: a reader that finds no frame waiting
        stops (`recv_frame` returns None from then on without waiting)."""
        self.closed = True

    def send(self, frame_bytes: bytes) -> int:
        return self._out.send(frame_bytes)

    def recv_chunk(self, timeout: Optional[float] = None) -> Optional[bytes]:
        """Next raw byte chunk off the wire, or None on timeout. The
        override point for byte-level interception (testing.faults)."""
        return self._in.recv(timeout=timeout)

    def recv_frame(self, timeout: Optional[float] = None):
        """Next complete frame, or None on timeout. Reassembles chunks.

        Raises `wire.WireError` if the stream is corrupt; frame boundaries
        after that are untrustworthy, so the caller must discard this
        endpoint (and may resume its sessions over a fresh one).
        """
        while not self._pending:
            chunk = self.recv_chunk(timeout=0.0 if self.closed else timeout)
            if chunk is None:
                return None
            self._reader.feed(chunk)
            for frame in self._reader.frames():
                self._pending.append(frame)
        return self._pending.pop(0)


def channel_pair():
    """(client_endpoint, server_endpoint) over two in-memory byte pipes."""
    up, down = _BytePipe(), _BytePipe()
    return Endpoint(up, down), Endpoint(down, up)
