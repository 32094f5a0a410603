"""Client/server decode steps for the streaming runtime.

The decode caches are stacked per layer and the cut splits the layer axis:
the client (feature owner) writes layers [0, cut), the server (label owner)
layers [cut, L) — each party touches only its own range, in place.

  * bottom step (client): embed -> layers [0, cut) -> the device codec,
    one fused launch of selection, encode and bit-pack on the card
    (`split.protocol.client_encode_device`); or, with the host codec
    (`make_bottom_step`), the payload pulled to the host for
    `wire.encode_payload_frame`.
  * arena top step (server): the cut rows of `xbuf` -> layers [cut, L) ->
    LM head -> greedy token, over the WHOLE arena with fixed shapes (rows
    are independent, so a row's numbers do not depend on which other rows
    are active; a moe layer routes each row as its own group of one
    token, as the reference's vmapped per-session step does); only the
    active rows' state (KV, SSM state and conv history, WKV state and
    token-shift inputs) and positions are written; the vlm's and
    whisper's cross KV is read, never written.
  * fused decode step: the flush payload decoded into `xbuf[slots]`, then
    the arena top step — one call per single-meta flush.

With a mesh (`repro_torch.mesh.Mesh`) the arena top step is the sharded
one (`_make_sharded_arena_step`, docs/sharding.md): rows over every mesh
position, a vocab-parallel head, and a pod ring; on a process mesh every
process runs its position's part of it (`server.serve_follower` drives
the processes other than position 0's).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch import mesh as mesh_mod
from repro_torch.core import compressors
from repro_torch.models import common, tp, transformer
from repro_torch.models.config import ArchConfig
from repro_torch.split import protocol


def bottom_hidden(params, cfg: ArchConfig, cut: int, cache, token):
    """Client half of the model: token (1, 1) -> cut activation (1, 1, d);
    writes layers [0, cut) of `cache` and advances its position."""
    dev = cache["pos"].device
    tok = torch.as_tensor(np.asarray(token), device=dev).reshape(1, 1)
    x = transformer.embed(params, cfg, tok)
    x = transformer.decode_layers(params, cfg, x, cache, 0, cut)
    cache["pos"] += 1
    return x


def make_bottom_step_device(cfg: ArchConfig, cut: int,
                            comp: compressors.Compressor) -> Callable:
    """(params, cache, token (1,1) i32) -> (Payload, sections): the device
    Payload (meta and batch shape for the frame subheader) and its packed
    wire sections. Inference-mode encode (RandTopK -> TopK)."""

    def bottom_step(params, cache, token):
        x = bottom_hidden(params, cfg, cut, cache, token)
        return protocol.client_encode_device(comp, x, training=False)

    return bottom_step


def make_bottom_step(cfg: ArchConfig, cut: int,
                     comp: compressors.Compressor) -> Callable:
    """(params, cache, token (1,1) i32) -> the host Payload (numpy leaves
    in the wire dtypes) for the host codec. Inference-mode encode."""

    def bottom_step(params, cache, token):
        x = bottom_hidden(params, cfg, cut, cache, token)
        return protocol.client_encode(comp, x, training=False)

    return bottom_step


def top_hidden(params, cfg: ArchConfig, cut: int, x, cache, rows):
    """Layers [cut, L) and the final norm over arena rows `x` (C, 1, d);
    writes the state of the `rows` (index vector) in place. Positions are
    the caller's to advance."""
    x = transformer.decode_layers(params, cfg, x, cache, cut, cfg.n_layers,
                                  rows)
    return transformer.final_norm(params, cfg, x)


def top_logits(params, cfg: ArchConfig, cut: int, xbuf, cache, rows):
    """Layers [cut, L) + LM head over every arena row; writes the state of
    the `rows` (index vector) in place. Returns logits (C, 1, V)."""
    C = cache["pos"].shape[0]
    h = top_hidden(params, cfg, cut, xbuf[:C].reshape(C, 1, cfg.d_model),
                   cache, rows)
    return h @ params["unembed"].to(h.dtype)


def make_arena_top_step(cfg: ArchConfig, cut: int, mesh=None,
                        registry=None) -> Callable:
    """(params, xbuf (C+1, 1, 1, d), cache (C rows), active (C,) numpy
    bool) -> tokens (C,) int32 on the device. Inactive slots compute and
    discard: their state and position are never written. With `mesh` the
    sharded step: `cache` is the arena's list of per-position blocks, the
    tokens come back in wire-row order (`SlotArena.wire_row`; on a process
    mesh to position 0 only, None elsewhere), and the collectives count
    their bytes into `registry` when given."""
    if mesh is not None:
        return _make_sharded_arena_step(cfg, cut, mesh, registry)

    def arena_step(params, xbuf, cache, active):
        dev = cache["pos"].device
        rows = torch.as_tensor(np.flatnonzero(active), device=dev)
        logits = top_logits(params, cfg, cut, xbuf, cache, rows)
        cache["pos"][rows] += 1
        return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)

    return arena_step


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def arena_reads(cfg: ArchConfig):
    """`transformer.param_spec`'s tree with True at each leaf every
    position of the sharded arena reads as exactly its 'model' block:
    `unembed`'s columns, which the head reads (`_make_sharded_arena_step`
    refuses a vocab 'model' does not divide). Every other leaf is read
    whole: each row's layers run mesh-less (`top_hidden`)."""
    return common.block_reads(transformer.param_spec(cfg), unembed=True)


def _make_sharded_arena_step(cfg: ArchConfig, cut: int, mesh,
                             registry) -> Callable:
    """The reference's `_make_sharded_arena_step`, one program per mesh
    position on its position's device, the collectives those of
    `repro_torch.mesh`:

      * arena rows shard over every mesh axis, flattened in axis order:
        position p holds rows [p r, (p + 1) r), r = capacity / positions,
        and runs layers [cut, L) on them, writing only its active rows
        (batch decomposition: each row's program is the mesh-less
        `top_hidden`);
      * with a 'pod' axis the cut activation first crosses the pod ring
        (`protocol.pod_ring_perm`): the server stages slot s at
        `SlotArena.wire_row(s)`, in the ring-previous pod's block, and
        the tokens return on the inverse ring;
      * the lm head is vocab-parallel over 'model': the model group's row
        gather (`tp.gather_seq_local`, after the norm), each rank's
        product with its 'model' columns of `unembed` (an output-dim
        split; no contraction is split; `tp.take`) and
        `tp.vocab_parallel_argmax`.

    Positions on the device the params lie on read them in place (the
    column slices are views of the one `unembed`); a position on another
    device reads a copy made there once per params object.

    On a process mesh every process calls the step with the same
    `active` mask, its own arena block (`SlotArena.cache`), its params
    (`unembed` held as its 'model' columns on every rank,
    `launch.specs.use_layouts(..., "arena")`; `run_streaming` makes them,
    and a whole `unembed` is sliced) and its `xbuf`: position 0's whole
    one, whose blocks it scatters, and the other processes' rows, which
    receive them (`mesh.scatter_rows`).
    Position 0 gets every position's own block of tokens back
    (`mesh.gather_rows`) and returns them in wire-row order; the other
    processes return None. Neither move is counted, so every process
    counts `roofline.analysis.serving_collective_costs` a step, as the
    single controller does."""
    n = mesh.size
    n_model = mesh.shape["model"]
    n_pod = mesh.shape.get("pod", 1)
    if cfg.padded_vocab % n_model:
        raise ValueError(f"padded vocab {cfg.padded_vocab} not divisible by "
                         f"model axis {n_model}")
    v_local = cfg.padded_vocab // n_model
    ranks = [mesh.coord(p, "model") for p in range(n)]
    copies: dict = {}               # device -> (params, their copy there)

    def on(params, dev):
        if params["embed"].device == dev:
            return params
        if dev not in copies or copies[dev][0] is not params:
            copies[dev] = (params, _to(params, dev))
        return copies[dev][1]

    def stage(xbuf, r):
        """Each position's block of `xbuf`, (r, 1, d) on its device."""
        if not mesh.procs:
            return [xbuf[p * r:(p + 1) * r].reshape(r, 1, cfg.d_model)
                    .to(dev) for p, dev in enumerate(mesh.devices)]
        mine = mesh_mod.scatter_rows(
            mesh, [xbuf[p * r:(p + 1) * r] for p in range(n)]
            if mesh.rank == 0 else None, xbuf)
        return mesh.each(lambda p: mine.reshape(r, 1, cfg.d_model))

    def arena_step(params, xbuf, blocks, active):
        C = active.shape[0]
        if C % n:
            raise ValueError(f"arena capacity {C} not divisible by the "
                             f"{n}-position row sharding (SlotArena pads "
                             f"for this)")
        r = C // n
        x = stage(xbuf, r)
        if n_pod > 1:
            x = mesh_mod.permute(mesh, x, "pod",
                                 protocol.pod_ring_perm(n_pod), registry)

        def hidden(p, xp):
            prm, cache = on(params, mesh.devices[p]), blocks[p]
            rows = torch.as_tensor(
                np.flatnonzero(active[p * r:(p + 1) * r]), device=xp.device)
            h = top_hidden(prm, cfg, cut, xp, cache, rows)
            cache["pos"][rows] += 1
            return h

        h = tp.gather_seq_local(mesh, mesh_mod.pmap(hidden, x),
                                registry=registry)

        def head(p, hp):
            w = tp.take(mesh, p, on(params, mesh.devices[p])["unembed"], 1,
                        v_local)
            return (hp @ w.to(hp.dtype))[:, -1, :]

        tok = tp.vocab_parallel_argmax(mesh, mesh_mod.pmap(head, h),
                                       registry=registry)
        if n_pod > 1:
            tok = mesh_mod.permute(
                mesh, tok, "pod", protocol.pod_ring_perm(n_pod, inverse=True),
                registry)
        # each position's own rows: its rank's block of the group's tokens
        own = mesh_mod.pmap(
            lambda p, t: t[ranks[p] * r:(ranks[p] + 1) * r], tok)
        if mesh.procs:
            got = mesh_mod.gather_rows(mesh, mesh_mod.first(own))
            return None if got is None else torch.cat(got)
        dev0 = mesh.devices[0]
        return torch.cat([t.to(dev0) for t in own])

    return arena_step


def make_fused_decode_step(top_step: Callable, *, backend=None) -> Callable:
    """(params, xbuf, payload, slots, cache, active) -> tokens: decode the
    stacked flush payload into `xbuf[slots]` (the decode kernel, or its
    plain version per `backend`), then the arena step."""

    def fused_step(params, xbuf, payload, slots, cache, active):
        protocol.server_decode_to_slots(xbuf, payload, slots,
                                        backend=backend)
        return top_step(params, xbuf, cache, active)

    return fused_step
