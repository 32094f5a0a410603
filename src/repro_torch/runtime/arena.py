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

`xbuf` has `capacity + 1` rows: row `capacity` is the scratch row that
group padding decodes into (zero rows, never a live session's data), so
the flush-size buckets keep fixed shapes whatever the fill.
"""
from __future__ import annotations

import torch


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

    def reset_slot(self, slot: int) -> None:
        """Restore one row to the fresh-session template, in place (slot
        reuse after a session closed). Serve-loop thread only."""
        def write(dst, src):
            for key, val in src.items():
                if isinstance(val, dict):
                    write(dst[key], val)
                else:
                    dst[key][slot] = val[0]
        write(self.cache, self._template)
