"""Input shapes and `meta` input specs for every (architecture x input
shape) dry-run combination: the port's `src/repro/launch/specs.py`.

Nothing here allocates: parameters, optimizer state, caches and batches
are tensors on the `meta` device (the reference's `jax.eval_shape` and
`ShapeDtypeStruct`s), of the reference's shapes and dtypes.

The reference's sharding trees have no counterpart. The port's parameters
stay whole, one tensor a leaf, and `models.tp.Layout` shards inside the
step, so `spec_to_shardings`, `opt_shardings` and `batch_shardings` go
away; `dp_only_spec` is `Runtime.dp_only`; and `_sanitize_spec`'s rule,
that a mesh axis which does not divide a dimension leaves it whole, is
`tp.Layout.whole` (a batch the batch axes do not divide) and
`tp.flash_split` (a KV ring or cross KV that 'model' does not divide).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig, Runtime
from repro_torch.optim.adamw import adamw_init
from repro_torch.split import model as split_model

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# long_500k: ssm runs natively (recurrent state); every other family serves
# it through the sliding-window variant (window 8192)
LONG_CTX_WINDOW = 8192


def adapt_config(cfg: ArchConfig, shape: ShapeSpec) -> ArchConfig:
    """Per-shape architecture adaptation (the sliding window for 500k)."""
    if shape.name == "long_500k" and cfg.family != "ssm":
        return cfg.with_(sliding_window=LONG_CTX_WINDOW)
    return cfg


def abstract_params(cfg: ArchConfig):
    """The model's parameters on `meta` (no draw reaches a device)."""
    return transformer.init_model(cfg, torch.Generator().manual_seed(0),
                                  device=META)


def _side(cfg: ArchConfig, batch: int) -> Dict[str, torch.Tensor]:
    """The vlm's patches or whisper's frames of `batch` rows, on `meta`."""
    if cfg.family == "vlm":
        return {"patches": torch.empty(
            (batch, cfg.n_image_tokens, cfg.d_model), dtype=cfg.adtype(),
            device=META)}
    if cfg.family == "audio":
        return {"frames": torch.empty(
            (batch, cfg.n_frames, cfg.d_model), dtype=cfg.adtype(),
            device=META)}
    return {}


def batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict:
    """The training or prefill batch on `meta`: tokens and labels (B, S)
    int32, with the vlm's patches or whisper's frames."""
    tok = torch.empty((shape.batch, shape.seq), dtype=torch.int32,
                      device=META)
    return {"tokens": tok, "labels": tok, **_side(cfg, shape.batch)}


def train_specs(cfg: ArchConfig, shape: ShapeSpec):
    """(params, opt_state, batch) for `launch.steps.make_train_step`."""
    params = abstract_params(cfg)
    return params, adamw_init(params), batch_specs(cfg, shape)


def decode_cache(cfg: ArchConfig, rt: Runtime, params, batch: int,
                 max_len: int, device, side=None):
    """An empty decode cache of `max_len` positions for `batch` rows on
    `device`, of the rows' `side` inputs (the vlm's patches, whisper's
    frames) through `params`. On a mesh it is each position's
    (`split.model.init_decode_cache` on the decode layout: whisper's
    encoder runs here, its pod-ring bytes counted into `rt.registry`),
    else `transformer.init_cache` (the cross KV of `make_extras`). The
    dry run builds it on `meta`, `chip_smoke.py` on the card."""
    if rt.mesh is not None:
        lay = split_model.decode_layout(cfg, rt, batch)
        return split_model.init_decode_cache(params, cfg, lay, max_len,
                                             side=side or None)
    with torch.no_grad():
        extras = (transformer.make_extras(params, cfg, rt, side)
                  if side else None)
    return transformer.init_cache(cfg, batch, max_len, device=device,
                                  params=params, extras=extras)


def decode_specs(cfg: ArchConfig, shape: ShapeSpec, rt: Runtime):
    """(params, cache, token (B, 1)) for `launch.steps.make_serve_step`:
    a `decode_cache` of `shape.seq` positions for B rows, on `meta`."""
    params = abstract_params(cfg)
    cache = decode_cache(cfg, rt, params, shape.batch, shape.seq, META,
                         _side(cfg, shape.batch))
    token = torch.empty((shape.batch, 1), dtype=torch.int32, device=META)
    return params, cache, token
