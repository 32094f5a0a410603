"""Split model: backbone forward with the cut-layer compression boundary.

The bottom layers' activation goes through `split.protocol.cut_boundary`
(encode to the wire leaves, decode on the far side, payload-typed
backward) before the top layers, so what the top model sees is exactly what
the compressed payload carries. On a training mesh (`Runtime.mesh`) the
same forward runs over one tensor per mesh position (`models.tp.Layout`)
and the cut is `protocol.cut_boundary_mesh`.
"""
from __future__ import annotations

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
    transformer.check_mesh_family(cfg)
    lay = tp.Layout(rt, *batch["tokens"].shape)
    shards = lay.shard_batch(batch)
    xs = transformer.embed_mesh(params, cfg, lay, shards)
    origin = list(range(len(shards)))
    if cfg.split is None or cfg.split.cut_layer <= 0:
        xs, aux = transformer.apply_layers_mesh(params, cfg, lay, xs, 0,
                                                cfg.n_layers)
    else:
        cut = _cut(cfg)
        xs, aux1 = transformer.apply_layers_mesh(params, cfg, lay, xs, 0,
                                                 cut)
        xs, pen, origin = protocol.cut_boundary_mesh(xs, cfg, lay,
                                                     generator)
        xs, aux2 = transformer.apply_layers_mesh(params, cfg, lay, xs, cut,
                                                 cfg.n_layers)
        aux = aux1 + aux2 + pen
    logits = [None] * len(shards)
    for b, lg in enumerate(transformer.lm_head_mesh(params, cfg, lay, xs)):
        logits[origin[b]] = lg
    return logits, aux
