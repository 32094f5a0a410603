"""Split model: backbone forward with the cut-layer compression boundary.

The bottom layers' activation goes through `split.protocol.cut_boundary`
(encode to the wire leaves, decode on the far side, payload-typed
backward) before the top layers, so what the top model sees is exactly what
the compressed payload carries.
"""
from __future__ import annotations

from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig, Runtime
from repro_torch.split import protocol


def forward(params, cfg: ArchConfig, rt: Runtime, batch, *, generator=None):
    """Bottom layers -> encode/decode at the cut -> top layers. Returns
    (logits, aux) where aux folds the MoE balance loss of both halves and
    the L1 cut-activation penalty.

    The cut runs outside any recomputed (remat) layer, so RandTopK draws
    its noise from `generator` once per forward."""
    if cfg.split is None or cfg.split.cut_layer <= 0:
        return transformer.forward(params, cfg, rt, batch)
    cut = cfg.split.cut_layer
    if not 0 < cut < cfg.n_layers:
        raise ValueError(f"cut_layer {cut} out of range (0, {cfg.n_layers})")
    extras = transformer.make_extras(params, cfg, rt, batch)
    x = transformer.embed(params, cfg, batch["tokens"])
    x, aux1 = transformer.apply_layers(params, cfg, rt, x, extras, 0, cut)
    x, pen = protocol.cut_boundary(x, cfg, rt, generator)
    x, aux2 = transformer.apply_layers(params, cfg, rt, x, extras, cut,
                                       cfg.n_layers)
    return transformer.lm_head(params, cfg, x), aux1 + aux2 + pen
