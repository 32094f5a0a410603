"""Split model: backbone forward with the cut-layer compression boundary.

The bottom layers' activation goes through `split.protocol.cut_boundary`
(encode to the wire leaves, decode on the far side, payload-typed
backward) before the top layers, so what the top model sees is exactly what
the compressed payload carries. On a training mesh (`Runtime.mesh`) the
same forward of every family runs over one tensor per mesh position
(`models.tp.Layout`): the embedding, the vlm's patches or whisper's
encoder (`transformer.make_extras_mesh`), the bottom layers, the cut
(`protocol.cut_boundary_mesh`), the top layers and the lm head.

`decode_step` is the whole batch's one-token step with a cache: bottom
layers, the cut's payload at inference (RandTopK encodes as TopK), top
layers, every generated token; on a decode mesh (`Runtime.mesh`, every
family) over one tensor per position (`tp.Layout(decode=True)`, the
cache from `init_decode_cache`), where `next_tokens` takes the greedy
tokens from the vocab-parallel head and brings them back to the batch's
rows.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import mesh as mesh_mod
from repro_torch.models import tp, transformer
from repro_torch.models.config import ArchConfig, Runtime
from repro_torch.split import protocol


def forward(params, cfg: ArchConfig, rt: Runtime, batch, *, generator=None):
    """Bottom layers -> encode/decode at the cut -> top layers. Returns
    (logits, aux) where aux folds the MoE balance loss of both halves and
    the L1 cut-activation penalty.

    The cut runs outside any recomputed (remat) layer, so RandTopK draws
    its noise from `generator` once per forward. On a mesh, logits is a
    list of each batch shard's (B_loc, S, V) logits in the batch's row
    order (`tp.Layout.shard_batch`), wherever the pod ring computed
    them; on a process mesh only the process's own shard has logits and
    its penalty is that shard's (`launch.steps` forms the loss)."""
    if rt.mesh is not None:
        _, logits, aux, pen = forward_mesh(params, cfg, rt, batch, generator)
        return logits, (aux if pen is None else aux + pen)
    if cfg.split is None or cfg.split.cut_layer <= 0:
        return transformer.forward(params, cfg, rt, batch)
    cut = _cut(cfg)
    extras = transformer.make_extras(params, cfg, rt, batch)
    x = transformer.embed(params, cfg, batch["tokens"])
    x, aux1 = transformer.apply_layers(params, cfg, rt, x, extras, 0, cut)
    x, pen = protocol.cut_boundary(x, cfg, rt, generator)
    x, aux2 = transformer.apply_layers(params, cfg, rt, x, extras, cut,
                                       cfg.n_layers)
    return transformer.lm_head(params, cfg, x), aux1 + aux2 + pen


def _cut(cfg: ArchConfig) -> int:
    cut = cfg.split.cut_layer
    if not 0 < cut < cfg.n_layers:
        raise ValueError(f"cut_layer {cut} out of range (0, {cfg.n_layers})")
    return cut


def forward_mesh(params, cfg: ArchConfig, rt: Runtime, batch, generator):
    """`forward` on a mesh, its loss terms apart: (the layout, logits,
    aux, pen). logits: one entry a batch shard, the logits of its rows
    (None where the process does not run them, `tp.Layout.held`); aux:
    the layers' balance loss (every position holds the same); pen: the
    cut's L1 penalty, the mean over the shards the process runs
    (`protocol.cut_boundary_mesh`), or None without a cut."""
    lay = tp.Layout(rt, *batch["tokens"].shape)
    shards = lay.shard_batch(batch)
    extras = transformer.make_extras_mesh(params, cfg, lay, shards)
    xs = transformer.embed_mesh(params, cfg, lay, shards)
    origin, pen = list(range(len(shards))), None
    if cfg.split is None or cfg.split.cut_layer <= 0:
        xs, aux = transformer.apply_layers_mesh(params, cfg, lay, xs, extras,
                                                0, cfg.n_layers)
    else:
        cut = _cut(cfg)
        xs, aux1 = transformer.apply_layers_mesh(params, cfg, lay, xs,
                                                 extras, 0, cut)
        xs, pen, origin = protocol.cut_boundary_mesh(xs, cfg, lay,
                                                     generator)
        extras = _extras_of_rows(cfg, lay, extras, shards, origin)
        xs, aux2 = transformer.apply_layers_mesh(params, cfg, lay, xs,
                                                 extras, cut, cfg.n_layers)
        aux = aux1 + aux2
    logits = [None] * len(shards)
    for (b, _), lg in zip(lay.held(),
                          transformer.lm_head_mesh(params, cfg, lay, xs)):
        logits[origin[b]] = lg
    return lay, logits, aux, pen


def _extras_of_rows(cfg: ArchConfig, lay, extras, shards, origin):
    """The side inputs of the rows each position holds after the cut: the
    pod ring moves shard origin[b]'s rows to shard b, so the vlm's top
    layers read origin[b]'s patches (batch data, read where they are, as
    the loss reads the labels) and whisper's encoder output crosses the
    ring with its rows (a collective-permute along 'pod',
    `protocol.pod_ring_perm`; the backward returns its gradient)."""
    if origin == list(range(len(origin))) or not extras:
        return extras
    if cfg.family == "vlm":
        return {"patches": lay.mesh.each(
            lambda p: shards[origin[lay.shard_of[p]]]["patches"])}
    return {"enc_out": mesh_mod.permute(
        lay.mesh, extras["enc_out"], "pod",
        protocol.pod_ring_perm(lay.mesh.shape["pod"]),
        registry=lay.registry)}


@torch.no_grad()
def decode_step(params, cfg: ArchConfig, rt: Runtime, token, cache):
    """One token of every row through the split model: token (B, 1) ->
    (logits (B, 1, V), cache). With no split, or a cut at 0, it is
    `transformer.decode_step`; else `decode_layers` over [0, cut), the
    cut's payload encoded and decoded with `rt.training` off (RandTopK
    as the deterministic TopK, the reference's `rt_inf`), then [cut, L)
    and the head. Every row sits at the same position; the cache
    (`transformer.init_cache`, or `transformer.init_cache_mesh` on a
    mesh) is written IN PLACE and returned, where the reference returns
    a new one.

    On a mesh (`rt.mesh`, a cache of `init_decode_cache`) the logits are
    each batch shard's vocab shards put together in the batch's row
    order, the caller's view of a vocab-sharded result (no collective;
    on a process mesh every process fetches every position's logits, an
    all-gather that is not counted: the output's fetch, as a single
    controller reads its positions' tensors);
    `launch.steps.make_serve_step` takes its tokens from the shards."""
    if rt.mesh is not None:
        lay, logits, origin = decode_mesh(params, cfg, rt, token, cache)
        if lay.mesh.procs:
            # the output's fetch: every position's logits, not counted
            logits = mesh_mod.gather_values(lay.mesh,
                                            mesh_mod.first(logits))
        split = lay.split(cfg.padded_vocab)
        rows = [None] * len(lay.groups)
        for b, group in enumerate(lay.groups):
            rows[origin[b]] = torch.cat([logits[p] for p in (
                group if split else group[:1])], dim=-1)
        return (rows[0] if lay.whole else torch.cat(rows)), cache
    if cfg.split is None or cfg.split.cut_layer <= 0:
        return transformer.decode_step(params, cfg, token, cache)
    cut = _cut(cfg)
    x = transformer.embed(params, cfg, token)
    x = transformer.decode_layers(params, cfg, x, cache, 0, cut)
    x, _ = protocol.cut_boundary(x, cfg, dataclasses.replace(
        rt, training=False), None)
    x = transformer.decode_layers(params, cfg, x, cache, cut, cfg.n_layers)
    cache["pos"] += 1
    return transformer.lm_head(params, cfg, x), cache


def decode_layout(cfg: ArchConfig, rt: Runtime, batch: int):
    """The decode mesh's layout of `batch` rows on `rt.mesh`: the
    training mesh's `tp.Layout` with one token a row, at inference."""
    transformer.check_decode_mesh(cfg)
    return tp.Layout(dataclasses.replace(rt, training=False, seq_shard=False),
                     batch, 1, decode=True)


@torch.no_grad()
def init_decode_cache(params, cfg: ArchConfig, lay, max_len: int,
                      bits: int = 16, side=None):
    """Each position's decode cache on the decode layout `lay`
    (`transformer.init_cache_mesh`), its cross KV (vlm, audio) of the
    rows the position holds at each layer. `side`: the batch's side
    inputs, the vlm's {"patches": (B, N, d)} or whisper's {"frames":
    (B, F, d)} (zeros without them, as `init_cache` serves).

    Layers [0, cut) hold the shard's own rows: their extras are
    `transformer.make_extras_mesh`'s (whisper's encoder runs here, once,
    on the mesh: `run_encoder_mesh`, with `seq_shard` off every position
    encodes its shard's frames whole). Layers [cut, L) hold the rows the
    pod ring hands over (`protocol.cut_origin`): the vlm reads their
    patches where they are, batch data, and whisper's encoder output
    crosses the ring with them (`_extras_of_rows`, a collective-permute
    counted into `lay.registry`: the cache's bytes,
    `roofline.analysis.decode_cache_collective_costs`, not a step's)."""
    extras = top = None
    if side:
        shards = lay.shard_batch(side)
        extras = transformer.make_extras_mesh(params, cfg, lay, shards)
        top = _extras_of_rows(cfg, lay, extras, shards,
                              protocol.cut_origin(cfg, lay))
    return transformer.init_cache_mesh(cfg, lay, max_len, bits,
                                       params=params, extras=extras,
                                       top_extras=top)


@torch.no_grad()
def decode_mesh(params, cfg: ArchConfig, rt: Runtime, token, caches):
    """`decode_step` on a decode mesh: each position embeds its batch
    shard's tokens (every row where the batch stays whole), runs the
    bottom layers, the cut (`protocol.cut_boundary_mesh`: the TopK codec
    once a batch shard, the payload over the pod ring with
    `transfer_over_pod`), the top layers against the caches of the rows
    it now holds (`init_decode_cache`: their KV and recurrent state, the
    cross KV of their patches or encoder output), and its share of the
    head. Returns (the layout, each
    position's logits (`transformer.lm_head_decode_mesh`), origin:
    origin[b] is the batch shard whose rows shard b's logits are)."""
    lay = decode_layout(cfg, rt, token.shape[0])
    shards = lay.shard_batch({"tokens": token})
    xs = transformer.embed_mesh(params, cfg, lay, shards)
    origin = list(range(len(shards)))
    if cfg.split is None or cfg.split.cut_layer <= 0:
        xs = transformer.decode_layers_mesh(params, cfg, lay, xs, caches, 0,
                                            cfg.n_layers)
    else:
        cut = _cut(cfg)
        xs = transformer.decode_layers_mesh(params, cfg, lay, xs, caches, 0,
                                            cut)
        xs, _, origin = protocol.cut_boundary_mesh(xs, cfg, lay, None)
        xs = transformer.decode_layers_mesh(params, cfg, lay, xs, caches,
                                            cut, cfg.n_layers)
    for c in caches:
        if c is not None:
            c["pos"] += 1
    return lay, transformer.lm_head_decode_mesh(params, cfg, lay, xs), origin


def next_tokens(cfg: ArchConfig, lay, logits, origin):
    """The greedy next token of every row, (B,) int64 in the batch's row
    order, from each position's last-token logits (B_loc, V or V / m):
    the exact argmax over a vocab split over 'model'
    (`tp.vocab_parallel_argmax`: an f32 max and an s32 min all-reduce),
    then, where the pod ring moved the rows at the cut, each shard's
    tokens back to the shard whose rows they are (a collective-permute
    along 'pod', the ring's inverse, `protocol.ring_permute`), so no row
    takes another's token. On a process mesh each process then fetches
    every shard's tokens (an all-gather of (B_loc,) int32 a position
    that is not counted: the output's fetch, which the single controller
    makes by reading its positions' tensors), so every process returns
    every row's token."""
    if lay.split(cfg.padded_vocab):
        toks = tp.vocab_parallel_argmax(lay.mesh, logits, "model",
                                        registry=lay.registry)
    else:
        toks = mesh_mod.pmap(
            lambda _, lg: torch.argmax(lg, dim=-1).to(torch.int32), logits)
    toks = [toks[p] for _, p in lay.held()]
    if origin != list(range(len(origin))):
        toks = protocol.ring_permute(lay, toks, protocol.pod_ring_perm(
            lay.mesh.shape["pod"], inverse=True))
    if lay.mesh.procs:
        got = mesh_mod.gather_values(lay.mesh, toks[0])
        toks = [got[r] for r in lay.reps]
    return (toks[0] if lay.whole else torch.cat(toks)).long()
