"""Device-resident session-slot arena — the serving runtime's hot state.

Every admitted session owns one slot: a fixed row of the pre-allocated
batched KV-cache/position tensors (`cache`, every leaf stacked over a
leading capacity axis) and of the cut-activation buffer (`xbuf`). The slot
is assigned at admission and never moves while the session is resident, so
the serve loop's per-flush work is: decode the flush's payloads into
`xbuf[slots]` on the device, run one top step over the whole arena with an
active-slot mask, read the token rows back.

Where the reference donates `cache` and `xbuf` to its jitted steps and
rebinds the results, the port updates both IN PLACE: the decode kernel
writes `xbuf` rows, the top step writes the KV rows and positions of the
active slots only, and `reset_slot` zeroes one row. All of these run on the
serve-loop thread, serialized with the step.

Eviction moves a row to the host and back: `fetch_slot` copies a row's KV
and position into new host tensors and `restore_slot` writes them into a
(possibly different) row. Both copies are synchronous — `fetch_slot`
returns only once the row is on the host — so the reset that hands the
row to another session, queued after the fetch, can never overwrite it
before it was read (a `non_blocking` copy into pageable memory could).
The server orders every row op FIFO on the serve-loop thread, so a
restore always follows its own eviction's fetch.

`xbuf` has `capacity + 1` rows: row `capacity` is the scratch row that
group padding decodes into (zero rows, never a live session's data), so
the flush-size buckets keep fixed shapes whatever the fill.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch


def _map(tree: Dict[str, Any], fn: Callable) -> Dict[str, Any]:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _write_row(dst: Dict[str, Any], row: Dict[str, Any], slot: int) -> None:
    """Copy one row (leaves without the capacity axis) into row `slot` of
    the stacked `dst`, in place."""
    for key, val in row.items():
        if isinstance(val, dict):
            _write_row(dst[key], val, slot)
        else:
            dst[key][slot].copy_(val)


class SlotArena:
    """Per-session serving state on one device.

    `make_cache(rows)` builds a rows-batched cache dict (`transformer.
    init_cache`); `x_shape`/`x_dtype` define one slot's cut-activation row.
    """

    def __init__(self, make_cache, capacity: int, x_shape, x_dtype, device):
        assert capacity >= 1
        self.capacity = capacity
        self._template = make_cache(1)
        self.cache = make_cache(capacity)
        self.xbuf = torch.zeros((capacity + 1,) + tuple(x_shape),
                                dtype=x_dtype, device=device)

    def wire_row(self, slot: int) -> int:
        """The `xbuf`/token row of a slot: the slot itself (the reference
        maps it across a mesh's pod axis; the port has no mesh)."""
        return slot

    def reset_slot(self, slot: int) -> None:
        """Restore one row to the fresh-session template, in place (slot
        reuse after a session closed or was evicted). Serve-loop thread
        only."""
        _write_row(self.cache, _map(self._template, lambda a: a[0]), slot)

    def fetch_slot(self, slot: int) -> Dict[str, Any]:
        """Host copy of one row's KV and position (leaves without the
        capacity axis) — the eviction path. Synchronous: the copy has
        landed when this returns. Serve-loop thread only."""
        return _map(self.cache, lambda a: a[slot].to("cpu", copy=True))

    def restore_slot(self, slot: int, state: Dict[str, Any]) -> None:
        """Write an evicted session's host state (`fetch_slot`) back into
        row `slot` — the re-admission path. Serve-loop thread only."""
        _write_row(self.cache, state, slot)

    def slot_cache(self, slot: int) -> Dict[str, Any]:
        """Host copy of one row (tests and debugging; the serve path never
        reads a row back)."""
        return self.fetch_slot(slot)
