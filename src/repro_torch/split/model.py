"""Split model: backbone forward with the cut-layer compression boundary.

The bottom layers' activation goes through `split.protocol.cut_boundary`
(encode to the wire leaves, decode on the far side, payload-typed
backward) before the top layers, so what the top model sees is exactly what
the compressed payload carries. On a training mesh (`Runtime.mesh`) the
same forward of every family runs over one tensor per mesh position
(`models.tp.Layout`): the embedding, the vlm's patches or whisper's
encoder (`transformer.make_extras_mesh`), the bottom layers, the cut
(`protocol.cut_boundary_mesh`), the top layers and the lm head.
"""
from __future__ import annotations

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
    them."""
    if rt.mesh is not None:
        return _forward_mesh(params, cfg, rt, batch, generator)
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


def _forward_mesh(params, cfg: ArchConfig, rt: Runtime, batch, generator):
    lay = tp.Layout(rt, *batch["tokens"].shape)
    shards = lay.shard_batch(batch)
    extras = transformer.make_extras_mesh(params, cfg, lay, shards)
    xs = transformer.embed_mesh(params, cfg, lay, shards)
    origin = list(range(len(shards)))
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
        aux = aux1 + aux2 + pen
    logits = [None] * len(shards)
    for b, lg in enumerate(transformer.lm_head_mesh(params, cfg, lay, xs)):
        logits[origin[b]] = lg
    return logits, aux


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
        return {"patches": [shards[origin[lay.shard_of[p]]]["patches"]
                            for p in range(lay.mesh.size)]}
    return {"enc_out": mesh_mod.permute(
        lay.mesh, extras["enc_out"], "pod",
        protocol.pod_ring_perm(lay.mesh.shape["pod"]),
        registry=lay.registry)}
