"""Device-resident session-slot arena — the serving runtime's hot state.

Every admitted session owns one slot: a fixed row of the pre-allocated
batched decode-state tensors (`cache`, every leaf stacked over a leading
capacity axis) and of the cut-activation buffer (`xbuf`). A row holds
its position and, by family (`transformer.init_cache`):

  * dense / moe: `kv` {k, v} of every layer;
  * hybrid (zamba2): `mamba` {h, conv} of every layer (the SSM state and
    the conv history) and `kv` of every shared-attention site;
  * ssm (rwkv6): `rwkv` {S, x_tm, x_cm} of every layer (the WKV state and
    the token-shift inputs);
  * vlm / audio: `kv` of every self-attention layer and `cross_kv` of
    every cross layer (the patches' or the encoder output's k and v,
    computed at init and never written by decode; `reset_slot`, the
    eviction copies and the top step carry it like any other leaf);

with `kv` as int8 codes plus `k_scale`/`v_scale` when the label owner
serves at `kv_cache_bits=8`. The slot is assigned at admission and never
moves while the session is resident, so the serve loop's per-flush work
is: decode the flush's payloads into `xbuf[slots]` on the device, run one
top step over the whole arena with an active-slot mask, read the token
rows back.

Where the reference donates `cache` and `xbuf` to its jitted steps and
rebinds the results, the port updates both IN PLACE: the decode kernel
writes `xbuf` rows, the top step writes the state and positions of the
active slots only, and `reset_slot` zeroes one row. All of these run on the
serve-loop thread, serialized with the step.

Eviction moves a row to the host and back: `fetch_slot` copies every
leaf of a row (whatever state kinds it holds) into new host tensors and
`restore_slot` writes them into a (possibly different) row. Both copies
are synchronous — `fetch_slot` returns only once the row is on the host —
so the reset that hands the row to another session, queued after the
fetch, can never overwrite it before it was read (a `non_blocking` copy
into pageable memory could). The server orders every row op FIFO on the
serve-loop thread, so a restore always follows its own eviction's fetch.

`xbuf` has `capacity + 1` rows: row `capacity` is the scratch row that
group padding decodes into (zero rows, never a live session's data), so
the flush-size buckets keep fixed shapes whatever the fill.

With a `mesh` (`repro_torch.mesh.Mesh`, docs/sharding.md) the rows shard
over every mesh position, flattened in axis order: `capacity` is the requested
capacity rounded up to a multiple of the position count, so each position
holds `capacity / positions` rows, and the server admits at most
`requested_capacity` sessions (pad rows stay inactive). `cache` is then a
list of one rows-batched cache dict per position, its row block on its
position's device; `xbuf` stays one buffer, replicated on position 0's
device (the reference's `P()`): the flush decode kernel writes it through
its slot map and the sharded step slices the live rows into the
positions' blocks. The row ops address a slot as (position, offset)
(`locate`). `mesh=None` is the single-device arena, unchanged.

On a process mesh (`repro_torch.mesh.ProcessMesh`, one process a
position) a process holds only its own position's block (None at the
others). Position 0 runs the server: its `xbuf` is whole and the step
scatters each position its block of rows; every other process holds
its `capacity / positions` rows of `xbuf`, the scatter's destination.
A row op runs on the row's owner: on position 0 `reset_slot`,
`fetch_slot` and `restore_slot` of a row another process owns leave the
reset to the owner, receive the owner's host copy (a fetch returns only
once it has arrived, so the FIFO rule above holds across processes) or
send the state to the owner; the owner runs its side of the same op in
the same order (`follow`), as the server's control record hands it on.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch import mesh as mesh_mod


def _map(tree: Dict[str, Any], fn: Callable) -> Dict[str, Any]:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _leaves(tree: Dict[str, Any]) -> list:
    """A tree's leaves in `_map`'s order."""
    out = []
    for val in tree.values():
        out += _leaves(val) if isinstance(val, dict) else [val]
    return out


def _write_row(dst: Dict[str, Any], row: Dict[str, Any], slot: int) -> None:
    """Copy one row (leaves without the capacity axis) into row `slot` of
    the stacked `dst`, in place."""
    for key, val in row.items():
        if isinstance(val, dict):
            _write_row(dst[key], val, slot)
        else:
            dst[key][slot].copy_(val)


class SlotArena:
    """Per-session serving state on one device, or sharded over a mesh.

    `make_cache(rows)` builds a rows-batched cache dict (`transformer.
    init_cache`); `x_shape`/`x_dtype` define one slot's cut-activation row.
    """

    def __init__(self, make_cache, capacity: int, x_shape, x_dtype, device,
                 mesh=None):
        assert capacity >= 1
        self.mesh = mesh
        n_pos = mesh.size if mesh is not None else 1
        self._n_pod = mesh.shape.get("pod", 1) if mesh is not None else 1
        self.requested_capacity = capacity
        self.capacity = -(-capacity // n_pos) * n_pos
        self._template = make_cache(1)
        rows = self.capacity + 1
        if mesh is None:
            self.cache = make_cache(capacity)
        else:
            device = mesh.devices[mesh.local[0]]
            self._rows = self.capacity // n_pos
            self.cache = mesh.each(lambda p: _map(
                make_cache(self._rows), lambda a: a.to(mesh.devices[p])))
            if mesh.procs and mesh.rank != 0:
                rows = self._rows
        self.xbuf = torch.zeros((rows,) + tuple(x_shape), dtype=x_dtype,
                                device=device)

    def wire_row(self, slot: int) -> int:
        """The `xbuf`/token row of a slot: the slot itself, but with a pod
        axis the slot's ingestion-pod block, the ring-previous pod's (the
        sharded step's forward ring carries the activation row to the
        slot's own block, the inverse ring its token back)."""
        if self._n_pod <= 1 or slot >= self.capacity:
            return slot
        block = self.capacity // self._n_pod
        pod, off = divmod(slot, block)
        return ((pod - 1) % self._n_pod) * block + off

    def locate(self, slot: int) -> Tuple[Dict[str, Any], int]:
        """(the cache dict holding a slot's row, the row's index in it)."""
        if self.mesh is None:
            return self.cache, slot
        return self.cache[slot // self._rows], slot % self._rows

    def owner(self, slot: int) -> int:
        """The mesh position holding a slot's row (0 without a mesh)."""
        return 0 if self.mesh is None else slot // self._rows

    def _elsewhere(self, slot: int) -> bool:
        """On a process mesh: the slot's row lies in another process."""
        return (self.mesh is not None and self.mesh.procs
                and self.owner(slot) != self.mesh.rank)

    def reset_slot(self, slot: int) -> None:
        """Restore one row to the fresh-session template, in place (slot
        reuse after a session closed or was evicted); a row of another
        process is its owner's to reset. Serve-loop thread only."""
        if self._elsewhere(slot):
            return
        cache, row = self.locate(slot)
        _write_row(cache, _map(self._template, lambda a: a[0]), row)

    def fetch_slot(self, slot: int) -> Dict[str, Any]:
        """Host copy of every leaf of one row (without the capacity axis)
        — the eviction path; a row of another process is received from
        its owner. Synchronous: the copy has landed when this returns.
        Serve-loop thread only."""
        if self._elsewhere(slot):
            return self._recv_row(self.owner(slot))
        cache, row = self.locate(slot)
        return _map(cache, lambda a: a[row].to("cpu", copy=True))

    def restore_slot(self, slot: int, state: Dict[str, Any]) -> None:
        """Write an evicted session's host state (`fetch_slot`) back into
        row `slot` — the re-admission path; a row of another process is
        sent to its owner. Serve-loop thread only."""
        if self._elsewhere(slot):
            self._send_row(state, self.owner(slot))
            return
        cache, row = self.locate(slot)
        _write_row(cache, state, row)

    def follow(self, kind: str, slot: int) -> None:
        """The owner's side of a row op that position 0 runs ("reset",
        "fetch" or "restore"), on a process mesh: a fetched row goes to
        position 0, a restored one comes from it. Nothing for a row of
        another process."""
        if self._elsewhere(slot):
            return
        if kind == "reset":
            self.reset_slot(slot)
        elif kind == "fetch":
            self._send_row(self.fetch_slot(slot), 0)
        else:
            self.restore_slot(slot, self._recv_row(0))

    def _send_row(self, state: Dict[str, Any], dst: int) -> None:
        """One row's host state to position `dst`, as one byte string."""
        mesh_mod.send_to(self.mesh, torch.cat([
            a.contiguous().reshape(-1).view(torch.uint8)
            for a in _leaves(state)]), dst)

    def _recv_row(self, src: int) -> Dict[str, Any]:
        """One row's host state from position `src` (`_send_row`), laid
        out as the template's row."""
        like = _leaves(self._template)
        sizes = [a[0].numel() * a.element_size() for a in like]
        flat = mesh_mod.recv_from(self.mesh, (sum(sizes),), torch.uint8,
                                  src, "cpu")
        leaves = iter(b.clone().view(a.dtype).reshape(a.shape[1:])
                      for a, b in zip(like, flat.split(sizes)))
        return _map(self._template, lambda _: next(leaves))

    def slot_cache(self, slot: int) -> Dict[str, Any]:
        """Host copy of one row (tests and debugging; the serve path never
        reads a row back)."""
        return self.fetch_slot(slot)
