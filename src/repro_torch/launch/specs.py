"""Input shapes and `meta` input specs for every (architecture x input
shape) dry-run combination: the port's `src/repro/launch/specs.py`.

Nothing here allocates: parameters, optimizer state, caches and batches
are tensors on the `meta` device (the reference's `jax.eval_shape` and
`ShapeDtypeStruct`s), of the reference's shapes and dtypes.

The reference's sharding trees drive the process mesh. Every parameter
leaf has a logical layout (`models.transformer.param_spec`, the
reference's `PartitionSpec`s as plain tuples); `param_shardings` resolves
it on a mesh as the reference's `spec_to_shardings` and
`sanitize_shardings` do (`dp_only_spec` under `Runtime.dp_only`,
`sanitize_spec`), and `opt_shardings` gives the AdamW moments the same
layouts. On a `mesh.ProcessMesh` each process keeps only its block of
every parameter and moment at rest (`mesh.shard`). While a step runs it
holds each leaf under `use_layouts`: its 'model' block where its
position reads exactly that block (the reference's tensor-parallel
matmuls read only theirs), else the whole leaf. The train step gathers
the rest blocks to the use blocks over the data axes only, and reduces
the gradients back among the positions that hold each use block
(`launch.steps`); decoding and the serving arena hold their use blocks,
made once. The dry run sums the blocks' bytes into its per-device
argument bytes and the use blocks' into a step's parameter bytes
(`launch.dryrun`). On the single controller the parameters stay whole,
one tensor a leaf, and `models.tp.Layout` shards inside the step
(`models.tp.take`); a batch the batch axes do not divide stays whole
(`tp.Layout.whole`), and so does a KV ring or cross KV that 'model' does
not divide (`tp.flash_split`), the counterparts of `batch_shardings` and
the cache's trees.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping

import torch

from repro_torch import mesh as mesh_mod
from repro_torch.models import tp, transformer
from repro_torch.models.config import ArchConfig, Runtime
from repro_torch.optim.adamw import adamw_init, tree_leaves, tree_map
from repro_torch.runtime import steps as runtime_steps
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


def dp_only_spec(spec: tuple) -> tuple:
    """The ZeRO-3 layout: no tensor parallelism ('model' -> whole) and the
    'data' dimension over ('data', 'model'), so a parameter splits over
    the whole mesh and is gathered for its use."""
    return tuple(None if e == "model" else ("data", "model") if e == "data"
                 else e for e in spec)


def _entry_axes(entry) -> tuple:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def sanitize_spec(spec: tuple, shape, mesh_shape: Mapping[str, int]
                  ) -> tuple:
    """`spec` with every entry whose mesh axes do not divide its
    dimension made whole (the reference's `_sanitize_spec`: a 4-way GQA
    projection on a 16-way 'model' axis, a vocab the axes do not divide).
    `mesh_shape` maps each axis to its size. An axis the mesh does not
    have, or one named twice, raises: no mesh takes that layout."""
    out, used = [], []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(entry)
            continue
        axes = _entry_axes(entry)
        missing = [a for a in axes if a not in mesh_shape]
        if missing or any(a in used for a in axes):
            raise ValueError(f"layout {spec} names "
                             f"{missing or axes}: not the axes of a mesh "
                             f"{dict(mesh_shape)}")
        used.extend(axes)
        n = math.prod(mesh_shape[a] for a in axes)
        out.append(entry if shape[i] % n == 0 else None)
    return tuple(out)


def param_shardings(cfg: ArchConfig, rt: Runtime, params):
    """Each leaf of `params` (whole tensors, or any tree of them with
    `init_model`'s shape, `meta` ones included) as its layout on
    `rt.mesh`: `transformer.param_spec`, `dp_only_spec` under
    `rt.dp_only`, then `sanitize_spec` against the leaf's shape."""
    mesh_shape = rt.mesh.shape

    def resolve(spec, leaf):
        if rt.dp_only:
            spec = dp_only_spec(spec)
        return sanitize_spec(spec, tuple(leaf.shape), mesh_shape)

    return tree_map(resolve, _matched(transformer.param_spec(cfg), params),
                    params)


def _matched(spec, params):
    """`spec` restricted to, and checked against, the tree of `params`."""
    if not isinstance(params, dict):
        if isinstance(spec, dict):
            raise ValueError(f"a layout tree {spec} where a leaf is")
        return spec
    if not isinstance(spec, dict) or set(spec) != set(params):
        raise ValueError(f"the layouts {spec} and the parameters "
                         f"{sorted(params)} differ")
    return {k: _matched(spec[k], v) for k, v in params.items()}


def opt_shardings(cfg: ArchConfig, rt: Runtime, params):
    """The AdamW state's layouts: the moments take the parameters'
    (`param_shardings`), `step` is replicated."""
    lay = param_shardings(cfg, rt, params)
    return {"mu": lay, "nu": lay, "step": ()}


USE_PATHS = ("train", "decode", "arena")


def use_layouts(cfg: ArchConfig, rt: Runtime, path: str, params=None, *,
                seq: int = None):
    """Each parameter leaf's layout while `path`'s step runs on `rt.mesh`
    ("train": `launch.steps.make_train_step`; "decode": the serve step and
    `split.model.decode_mesh`, with the decode cache they build; "arena":
    the sharded serving arena, `runtime.steps`): its `param_shardings`
    layout with every axis but 'model' dropped where every position reads
    exactly its 'model' block of the leaf on that path, else whole (every
    entry None). Which leaves those are, the model code says beside each
    layout (`transformer.param_reads` on the path's `tp.Layout`: each
    module's `*_reads` beside its `*_spec`; `runtime.steps.arena_reads`).
    Under `rt.dp_only`, or on a mesh without a 'model' axis of more than
    one position, every leaf is whole. `params`: whole tensors (`meta`
    ones do) shaped as the model's, default `abstract_params(cfg)`.
    `seq`: the training batch's sequence length (default: one that
    'model' divides), which decides whether the layers split
    (`tp.Layout.seq`). A tree shaped like `param_spec`."""
    if path not in USE_PATHS:
        raise ValueError(f"use layouts of {path!r}: one of {USE_PATHS}")
    params = abstract_params(cfg) if params is None else params
    store = param_shardings(cfg, rt, params)
    m = rt.mesh.shape.get("model", 1)
    if rt.dp_only or m == 1:
        return tree_map(lambda lay: (None,) * len(lay), store)
    groups = rt.mesh.size // m
    if path == "arena":
        reads = runtime_steps.arena_reads(cfg)
    elif path == "train":
        reads = transformer.param_reads(
            cfg, tp.Layout(rt, groups, m if seq is None else seq))
    else:
        reads = transformer.param_reads(
            cfg, split_model.decode_layout(cfg, rt, groups))

    def use(lay, block):
        if not block:
            return (None,) * len(lay)
        return tuple("model" if e is not None and "model" in _entry_axes(e)
                     else None for e in lay)

    return tree_map(use, store, _matched(reads, store))


def shard_tree(mesh, tree, layouts):
    """This process's block of every whole leaf of `tree` (`mesh.shard`:
    a leaf the layout keeps whole is `tree`'s own tensor, not a copy)."""
    return tree_map(lambda t, lay: mesh_mod.shard(mesh, t, lay), tree,
                    layouts)


def gather_tree(mesh, blocks, layouts, like):
    """The whole leaves of `blocks`, each of the shape of its leaf of
    `like` (whole tensors, `meta` ones included), from every process's
    blocks (`mesh.gather`, a collective: every process calls it)."""
    return tree_map(lambda b, lay, w: mesh_mod.gather(mesh, b, lay,
                                                      w.shape),
                    blocks, layouts, like)


def block_bytes(tree, layouts, mesh_shape: Mapping[str, int]) -> int:
    """The bytes of one position's blocks of every leaf of `tree` under
    `layouts` (each dimension divided by the mesh axes of its entry)."""
    total = 0
    for t, lay in zip(tree_leaves(tree), tree_leaves(layouts)):
        n = math.prod(mesh_shape[a] for e in lay if e is not None
                      for a in _entry_axes(e))
        total += t.numel() // n * t.element_size()
    return total


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
