"""Decoder model of the dense, moe, hybrid, ssm, vlm and audio families:
embed -> layer stack -> LM head, as a full-sequence forward (training /
prefill) and as one-token decode. Each block sits behind its norm (RMS,
or layer norm with a bias where `cfg.norm` is "layer"):

  * dense / moe: attention, then an MLP or a mixture of experts;
  * hybrid (zamba2): a Mamba2 mixer (`models.ssm`); after every
    `attn_every`-th layer one SHARED attention + MLP block (`shared_attn`,
    `shared_mlp`, one set of weights for every site) with its own KV
    cache per site;
  * ssm (rwkv6): RWKV6 time-mix, then channel-mix (`models.rwkv`);
  * vlm (llama-3.2-vision): groups of `cross_attn_every` layers, each
    `g - 1` dense self layers (`layers`, stacked over every self layer)
    and one cross layer (`cross_layers`): gated cross attention over the
    batch's image patches, then a gated MLP;
  * audio (whisper): a bidirectional encoder over the batch's frames
    (`enc_layers`, sinusoidal positions, `enc_norm`, run once per
    forward by `make_extras`), and decoder layers of causal self
    attention, cross attention over the encoder output (`cross`) and an
    MLP.

Parameters are a plain dict mirroring the reference's tree (layers stacked
on axis 0), so `models.convert.params_from_jax` is a one-to-one map and
every product takes the same operands as in the reference. The split-
learning cut is a residual-stream boundary: `apply_layers(..., lo, hi)`
runs any contiguous layer range (for the vlm, whole groups), and
`split.model.forward` composes bottom range -> cut codec -> top range.

On a training mesh (`Runtime.mesh`) the same layers of every family run
over one tensor per mesh position (`embed_mesh`, `make_extras_mesh`,
`apply_layers_mesh`, `lm_head_mesh`): the residual sharded over 'model'
along the sequence at every layer boundary, each norm's output gathered
to full S (`models.tp`), and split over 'model' where they divide:
attention's and cross attention's q heads, the MLP's and the channel
mix's ff columns, the moe's experts, Mamba2's and the RWKV6 time mix's
heads. Whisper's encoder runs on the mesh too, its frames sharded along
F (`run_encoder_mesh`).

`decode_step` is the whole batch's one-token step over `init_cache`.
On a decode mesh (`tp.Layout(decode=True)`, every family) every position
holds its batch shard's rows whole and its cache (`init_cache_mesh`:
with flash decode a 1/model share of each ring's slots and of each cross
KV's tokens; its heads' share of the Mamba2 and RWKV6 state), and
`decode_layers_mesh` splits attention, cross attention, the MLP, the
experts and the Mamba2 and RWKV6 heads over 'model', each closed by a
sum (`lm_head_decode_mesh`: the vocab split over 'model').
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import mesh as mesh_mod
from repro_torch.models import attention, common, mlp, moe, rwkv, ssm, tp
from repro_torch.models.config import ArchConfig, Runtime

FAMILIES = ("dense", "moe", "hybrid", "ssm", "vlm", "audio")


def check_family(cfg: ArchConfig):
    """Raise for a family the port does not know, and for a vlm whose
    depth is not whole groups of `cross_attn_every` layers."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} (known: "
                         f"{FAMILIES})")
    if cfg.family == "vlm" and cfg.n_layers % cfg.cross_attn_every:
        raise ValueError(f"vlm n_layers {cfg.n_layers} must be a multiple "
                         f"of cross_attn_every {cfg.cross_attn_every}")


def init_model(cfg: ArchConfig, generator: torch.Generator, device=None):
    """Random weights drawn from `generator` (on `device`)."""
    check_family(cfg)
    dt, L, d = cfg.pdtype(), cfg.n_layers, cfg.d_model

    def w(shape, scale=0.02):
        return common.normal_init(generator, shape, dt, scale, device=device)

    def attn_mlp(n, gated=False):
        return {"attn": attention.init_attention(generator, cfg, n, device,
                                                 gated=gated),
                "mlp": mlp.init_mlp(generator, cfg, n, device, gated=gated)}

    params = {
        "embed": w((cfg.padded_vocab, d)),
        "final_norm": common.init_norm(d, dt, device, cfg.norm),
        "unembed": w((d, cfg.padded_vocab)),
    }
    if cfg.family == "hybrid":
        params["layers"] = ssm.init_mamba(generator, cfg, L, device)
        params["shared_attn"] = _unstack(attention.init_attention(
            generator, cfg, 1, device))
        params["shared_mlp"] = _unstack(mlp.init_mlp(generator, cfg, 1,
                                                     device))
    elif cfg.family == "ssm":
        params["layers"] = {
            "time": rwkv.init_rwkv_time(generator, cfg, L, device),
            "chan": rwkv.init_rwkv_channel(generator, cfg, L, device)}
    elif cfg.family == "vlm":
        n_cross = L // cfg.cross_attn_every
        params["layers"] = attn_mlp(L - n_cross)
        params["cross_layers"] = attn_mlp(n_cross, gated=True)
    elif cfg.family == "audio":
        params["enc_layers"] = attn_mlp(cfg.n_enc_layers)
        params["enc_norm"] = common.init_norm(d, dt, device, cfg.norm)
        params["layers"] = {
            "attn": attention.init_attention(generator, cfg, L, device),
            "cross": attention.init_attention(generator, cfg, L, device),
            "mlp": mlp.init_mlp(generator, cfg, L, device)}
    else:
        layers = {"attn": attention.init_attention(generator, cfg, L,
                                                   device)}
        if cfg.family == "moe":
            layers["moe"] = moe.init_moe(generator, cfg, L, device)
        else:
            layers["mlp"] = mlp.init_mlp(generator, cfg, L, device)
        params["layers"] = layers
    return params


def _layer_spec(cfg: ArchConfig):
    p = {"attn": attention.attention_spec(cfg)}
    if cfg.family == "moe":
        p["moe"] = moe.moe_spec(cfg)
    else:
        p["mlp"] = mlp.mlp_spec(cfg)
    return p


def param_spec(cfg: ArchConfig):
    """The logical layout of every parameter leaf, a tree shaped like
    `init_model`'s (the reference's `transformer.param_spec`); the
    stacked layers lead with a whole layer dimension.
    `launch.specs.param_shardings` resolves it on a mesh."""
    check_family(cfg)
    spec = {
        "embed": ("model", "data"),
        "final_norm": common.norm_spec(cfg.norm),
        "unembed": ("data", "model"),
    }
    st = common.stacked_spec
    if cfg.family in ("dense", "moe"):
        spec["layers"] = st(_layer_spec(cfg))
    elif cfg.family == "hybrid":
        spec["layers"] = st(ssm.mamba_spec(cfg))
        spec["shared_attn"] = attention.attention_spec(cfg)
        spec["shared_mlp"] = mlp.mlp_spec(cfg)
    elif cfg.family == "ssm":
        spec["layers"] = st({"time": rwkv.rwkv_time_spec(cfg),
                             "chan": rwkv.rwkv_channel_spec(cfg)})
    elif cfg.family == "vlm":
        spec["layers"] = st(_layer_spec(cfg))
        spec["cross_layers"] = st({
            "attn": attention.attention_spec(cfg, gated=True),
            "mlp": mlp.mlp_spec(cfg, gated=True)})
    elif cfg.family == "audio":
        spec["enc_layers"] = st({"attn": attention.attention_spec(cfg),
                                 "mlp": mlp.mlp_spec(cfg)})
        spec["enc_norm"] = common.norm_spec(cfg.norm)
        spec["layers"] = st({"attn": attention.attention_spec(cfg),
                             "cross": attention.attention_spec(cfg),
                             "mlp": mlp.mlp_spec(cfg)})
    return spec


def _layer_reads(cfg: ArchConfig, lay):
    p = {"attn": attention.attention_reads(cfg, lay, flash=lay.flash)}
    if cfg.family == "moe":
        p["moe"] = moe.moe_reads(cfg, lay)
    else:
        p["mlp"] = mlp.mlp_reads(cfg, lay)
    return p


def param_reads(cfg: ArchConfig, lay):
    """`param_spec`'s tree with True at each leaf every position of `lay`
    (a training or decode `tp.Layout`) reads as exactly its 'model' block,
    False where a position reads more: each module's `*_reads` beside
    its `*_spec`. `embed` is read whole (`embed_mesh`: every row);
    `unembed` by its 'model' columns in decode where 'model' divides the
    vocab (`lm_head_decode_mesh`), whole in training (`lm_head_mesh`:
    every column once a batch shard). Self attention in decode keeps wq
    whole wherever flash decode is on (`lay.flash`: whether a ring splits
    depends on its size, `tp.Layout.ring_split`); cross attention where
    the cross tokens split (`cross_split`). Whisper's encoder reads on its
    own layout (`encoder_layout`). `launch.specs.use_layouts` walks it."""
    check_family(cfg)
    block = common.block_reads
    reads = block({"embed": (), "final_norm": common.norm_spec(cfg.norm),
                   "unembed": ()},
                  unembed=lay.decode and lay.split(cfg.padded_vocab))
    fam = cfg.family
    if fam in ("dense", "moe"):
        reads["layers"] = _layer_reads(cfg, lay)
    elif fam == "hybrid":
        reads["layers"] = ssm.mamba_reads(cfg, lay)
        reads["shared_attn"] = attention.attention_reads(cfg, lay,
                                                         flash=lay.flash)
        reads["shared_mlp"] = mlp.mlp_reads(cfg, lay)
    elif fam == "ssm":
        reads["layers"] = {"time": rwkv.rwkv_time_reads(cfg, lay),
                           "chan": rwkv.rwkv_channel_reads(cfg, lay)}
    elif fam == "vlm":
        reads["layers"] = _layer_reads(cfg, lay)
        reads["cross_layers"] = {
            "attn": attention.attention_reads(
                cfg, lay, gated=True, flash=cross_split(cfg, lay)),
            "mlp": mlp.mlp_reads(cfg, lay, gated=True)}
    elif fam == "audio":
        enc = encoder_layout(lay, cfg.n_frames)
        reads["enc_layers"] = {"attn": attention.attention_reads(cfg, enc),
                               "mlp": mlp.mlp_reads(cfg, enc)}
        reads["enc_norm"] = block(common.norm_spec(cfg.norm))
        reads["layers"] = {
            "attn": attention.attention_reads(cfg, lay, flash=lay.flash),
            "cross": attention.attention_reads(
                cfg, lay, flash=cross_split(cfg, lay)),
            "mlp": mlp.mlp_reads(cfg, lay)}
    return reads


def _unstack(tree):
    """A stack of one layer -> that layer's weights."""
    return {k: _unstack(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


def layer_params(params, layer: int, stack: str = "layers"):
    """One layer's weights of the stack `stack` ("layers", the vlm's
    "cross_layers", whisper's "enc_layers") as views into the stacked
    tensors."""
    def pick(tree):
        return {k: pick(v) if isinstance(v, dict) else v[layer]
                for k, v in tree.items()}
    return pick(params[stack])


def attn_sites(cfg: ArchConfig):
    """Hybrid: for each layer, the index of the shared-attention site that
    follows it (its KV cache), or -1 where none does."""
    out, s = [], 0
    for i in range(cfg.n_layers):
        if cfg.attn_every and (i + 1) % cfg.attn_every == 0:
            out.append(s)
            s += 1
        else:
            out.append(-1)
    return out


def blocks(cfg: ArchConfig, lo: int, hi: int):
    """The blocks of layers [lo, hi) in order: ("layer", i) is entry i of
    `params["layers"]` (and of `cache["kv"]`), ("cross", s) the vlm's
    cross layer s (`params["cross_layers"]`, `cache["cross_kv"]`). A vlm
    range must hold whole groups (g = `cross_attn_every`: g - 1 self
    layers, then one cross layer); the reference reads a range that does
    not as groups lo // g .. hi // g without a word, the port raises."""
    if cfg.family != "vlm":
        return [("layer", i) for i in range(lo, hi)]
    g = cfg.cross_attn_every
    if lo % g or hi % g:
        raise ValueError(f"vlm layer range [{lo}, {hi}) is not whole groups "
                         f"of cross_attn_every={g} layers")
    out = []
    for s in range(lo // g, hi // g):
        out += [("layer", s * (g - 1) + j) for j in range(g - 1)]
        out.append(("cross", s))
    return out


def _norm(cfg: ArchConfig, x, p):
    return common.apply_norm(x, p, cfg.norm)


def embed(params, cfg: ArchConfig, tokens):
    """tokens (B, S) -> (B, S, d) in the activation dtype."""
    return params["embed"][tokens.long()].to(cfg.adtype())


def final_norm(params, cfg: ArchConfig, x):
    return _norm(cfg, x, params["final_norm"])


def lm_head(params, cfg: ArchConfig, x):
    x = final_norm(params, cfg, x)
    return x @ params["unembed"].to(x.dtype)


def _ffn(pl, cfg: ArchConfig, rt: Runtime, x, per_row: bool = False):
    """The layer's second half on the normed residual: (the MLP, None) or
    (the mixture of experts, its balance loss)."""
    if cfg.family == "moe":
        return moe.moe(pl["moe"], cfg, rt, _norm(cfg, x, pl["moe"]["norm"]),
                       per_row=per_row)
    return mlp.mlp(pl["mlp"], _norm(cfg, x, pl["mlp"]["norm"])), None


def _shared_block(params, cfg: ArchConfig, rt: Runtime, x):
    """Hybrid: the shared attention + MLP block, full sequence."""
    sa, sm = params["shared_attn"], params["shared_mlp"]
    h = x + attention.full_attention(sa, cfg, rt, _norm(cfg, x, sa["norm"]))
    return h + mlp.mlp(sm, _norm(cfg, h, sm["norm"]))


def _cross_fwd(pl, cfg: ArchConfig, x, kv_tokens=None, kv_cache=None):
    """The vlm's cross layer: gated cross attention over the image tokens
    (or their cache), then the gated MLP."""
    x = x + attention.cross_attention(
        pl["attn"], cfg, _norm(cfg, x, pl["attn"]["norm"]), kv_tokens,
        kv_cache=kv_cache, gated=True)
    return x + mlp.mlp(pl["mlp"], _norm(cfg, x, pl["mlp"]["norm"]),
                       gated=True)


def _block_fwd(params, block, cfg: ArchConfig, rt: Runtime, x, extras):
    """One block (`blocks`) over x (B, S, d): (x, its moe balance loss or
    None)."""
    kind, i = block
    if kind == "cross":
        return _cross_fwd(layer_params(params, i, "cross_layers"), cfg, x,
                          extras["patches"]), None
    pl = layer_params(params, i)
    if cfg.family == "hybrid":
        x = x + ssm.mamba(pl, cfg, rt, _norm(cfg, x, pl["norm"]))
        if attn_sites(cfg)[i] >= 0:
            x = _shared_block(params, cfg, rt, x)
        return x, None
    if cfg.family == "ssm":
        pt, pc = pl["time"], pl["chan"]
        x = x + rwkv.rwkv_time_mix(pt, cfg, rt, _norm(cfg, x, pt["norm"]))[0]
        return x + rwkv.rwkv_channel_mix(pc, _norm(cfg, x, pc["norm"])), None
    x = x + attention.full_attention(pl["attn"], cfg, rt,
                                     _norm(cfg, x, pl["attn"]["norm"]))
    if cfg.family == "audio":
        x = x + attention.cross_attention(
            pl["cross"], cfg, _norm(cfg, x, pl["cross"]["norm"]),
            extras["enc_out"])
    y, aux = _ffn(pl, cfg, rt, x)
    return x + y, aux


def _remat(rt: Runtime, fn, *args):
    """fn(*args), recomputed in the backward instead of keeping its
    activations when `rt.remat` and autograd are on; nothing random runs
    inside a block, so the recompute gives the forward's numbers."""
    if rt.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def apply_layers(params, cfg: ArchConfig, rt: Runtime, x, extras, lo: int,
                 hi: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run layers [lo, hi) over x (B, S, d). Returns (x, aux loss): the
    moe family's balance losses summed over the layers, in layer order as
    the reference sums them (0 for the other families). With `rt.remat`
    each block (`blocks`; a hybrid layer with its shared block) is
    recomputed in the backward. `extras` (`make_extras`) carries the
    vlm's patches or whisper's encoder output."""
    check_family(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for block in blocks(cfg, lo, hi):
        x, a = _remat(rt, _block_fwd, params, block, cfg, rt, x, extras)
        if a is not None:
            aux = aux + a
    return x, aux


def _enc_layer_fwd(params, i: int, cfg: ArchConfig, rt: Runtime, x):
    pl = layer_params(params, i, "enc_layers")
    x = x + attention.full_attention(
        pl["attn"], cfg, rt, _norm(cfg, x, pl["attn"]["norm"]),
        causal=False, rope=False)
    return x + mlp.mlp(pl["mlp"], _norm(cfg, x, pl["mlp"]["norm"]))


def run_encoder(params, cfg: ArchConfig, rt: Runtime, frames):
    """Whisper's encoder over the stubbed frame embeddings (B, F, d):
    sinusoidal positions added, bidirectional attention without RoPE,
    then `enc_norm`."""
    pos = common.sinusoidal_positions(frames.shape[1], cfg.d_model,
                                      device=frames.device)
    x = frames + pos[None].to(frames.dtype)
    for i in range(cfg.n_enc_layers):
        x = _remat(rt, _enc_layer_fwd, params, i, cfg, rt, x)
    return _norm(cfg, x, params["enc_norm"])


def make_extras(params, cfg: ArchConfig, rt: Runtime, batch) -> dict:
    """Family-specific side inputs from the batch dict: the vlm's
    `patches`, whisper's `enc_out` (the encoder, run once here for both
    halves of a split forward); none for the other families."""
    if cfg.family == "vlm":
        return {"patches": batch["patches"]}
    if cfg.family == "audio":
        return {"enc_out": run_encoder(params, cfg, rt, batch["frames"])}
    return {}


def forward(params, cfg: ArchConfig, rt: Runtime, batch):
    """Full forward (no split). Returns (logits (B, S, V), aux loss). On a
    mesh the forward is `split.model.forward`'s."""
    if rt.mesh is not None:
        raise ValueError("transformer.forward runs without a mesh; "
                         "split.model.forward runs on one")
    extras = make_extras(params, cfg, rt, batch)
    x = embed(params, cfg, batch["tokens"])
    x, aux = apply_layers(params, cfg, rt, x, extras, 0, cfg.n_layers)
    return lm_head(params, cfg, x), aux


# ---------------------------------------------------------------------------
# The training mesh (`tp.Layout`): lists of one tensor per mesh position.
# ---------------------------------------------------------------------------

def embed_mesh(params, cfg: ArchConfig, lay, shards):
    """Each position's embedded tokens: its batch shard's rows (`shards`,
    one batch dict a shard), its chunk of the sequence. The lookup reads
    every row of `embed`: a position holds it whole (`tp.take` of every
    row)."""
    return lay.mesh.each(lambda p: embed(
        {"embed": tp.take(lay, p, params["embed"], 0, cfg.padded_vocab)},
        cfg, lay.local_seq(p, shards[lay.shard_of[p]]["tokens"])))


def _normed(cfg: ArchConfig, lay, xs, p):
    """Every position's residual normed, then gathered to full S
    (`tp.gather_seq`, after the norm, as
    `src/repro/models/transformer.py:131-146`)."""
    return tp.gather_seq(lay, mesh_mod.pmap(lambda _, x: _norm(cfg, x, p),
                                            xs))


def _plus(xs, ys):
    return mesh_mod.pmap(lambda _, x, y: x + y, xs, ys)


def _dense_mesh(pl, cfg: ArchConfig, lay, xs):
    """Attention, then the MLP or the experts, on the mesh: (xs, the moe's
    balance loss or None)."""
    xs = _plus(xs, attention.full_attention_mesh(
        pl["attn"], cfg, lay, _normed(cfg, lay, xs, pl["attn"]["norm"])))
    if cfg.family == "moe":
        ys, aux = moe.moe_mesh(pl["moe"], cfg, lay,
                               _normed(cfg, lay, xs, pl["moe"]["norm"]))
    else:
        ys, aux = mlp.mlp_mesh(pl["mlp"], cfg, lay,
                               _normed(cfg, lay, xs, pl["mlp"]["norm"])), None
    return _plus(xs, ys), aux


def _block_fwd_mesh(params, block, cfg: ArchConfig, lay, xs, extras):
    """`_block_fwd` on the mesh over each position's residual xs, extras
    each position's (`make_extras_mesh`): every norm's output is
    gathered to full S, each mixer returns each position's chunk.
    Returns (xs, the moe's balance loss or None)."""
    kind, i = block
    if kind == "cross":
        pl = layer_params(params, i, "cross_layers")
        xs = _plus(xs, attention.cross_attention_mesh(
            pl["attn"], cfg, lay, _normed(cfg, lay, xs, pl["attn"]["norm"]),
            extras["patches"], gated=True))
        return _plus(xs, mlp.mlp_mesh(
            pl["mlp"], cfg, lay, _normed(cfg, lay, xs, pl["mlp"]["norm"]),
            gated=True)), None
    pl = layer_params(params, i)
    if cfg.family == "hybrid":
        xs = _plus(xs, ssm.mamba_mesh(pl, cfg, lay,
                                      _normed(cfg, lay, xs, pl["norm"])))
        if attn_sites(cfg)[i] >= 0:
            xs, _ = _dense_mesh({"attn": params["shared_attn"],
                                 "mlp": params["shared_mlp"]}, cfg, lay, xs)
        return xs, None
    if cfg.family == "ssm":
        pt, pc = pl["time"], pl["chan"]
        xs = _plus(xs, rwkv.rwkv_time_mix_mesh(
            pt, cfg, lay, _normed(cfg, lay, xs, pt["norm"])))
        return _plus(xs, rwkv.rwkv_channel_mix_mesh(
            pc, cfg, lay, _normed(cfg, lay, xs, pc["norm"]))), None
    if cfg.family == "audio":
        xs = _plus(xs, attention.full_attention_mesh(
            pl["attn"], cfg, lay, _normed(cfg, lay, xs, pl["attn"]["norm"])))
        xs = _plus(xs, attention.cross_attention_mesh(
            pl["cross"], cfg, lay,
            _normed(cfg, lay, xs, pl["cross"]["norm"]), extras["enc_out"]))
        return _plus(xs, mlp.mlp_mesh(
            pl["mlp"], cfg, lay, _normed(cfg, lay, xs,
                                         pl["mlp"]["norm"]))), None
    return _dense_mesh(pl, cfg, lay, xs)


def apply_layers_mesh(params, cfg: ArchConfig, lay, xs, extras, lo: int,
                      hi: int):
    """`apply_layers` on the mesh: xs and the result hold each position's
    residual, (B_loc, S/model, d) under sequence parallelism; `extras`
    is `make_extras_mesh`'s. With `rt.remat` each block's program over
    every position is recomputed in the backward up to its last saved
    tensor (checkpoint's early stop): every forward collective of the
    block runs again but its trailing ones, whose results no gradient
    needs: the output reduce-scatter of a split MLP (dense, vlm self,
    whisper decoder, zamba2's shared block) or of Mamba2 in a layer
    without a shared-attention site, and the moe's combine and
    balance-loss all-reduce. A gated cross layer's MLP and RWKV6's
    channel mix are not trailing: the gate's and the receptance's
    products save the reduce-scattered chunk."""
    check_family(cfg)
    aux = torch.zeros((), dtype=torch.float32,
                      device=mesh_mod.first(xs).device)
    for block in blocks(cfg, lo, hi):
        xs, a = _remat(lay.rt, _block_fwd_mesh, params, block, cfg, lay, xs,
                       extras)
        if a is not None:
            aux = aux + a
    return xs, aux


def _enc_layer_fwd_mesh(params, i: int, cfg: ArchConfig, enc, xs):
    pl = layer_params(params, i, "enc_layers")
    xs = _plus(xs, attention.full_attention_mesh(
        pl["attn"], cfg, enc, _normed(cfg, enc, xs, pl["attn"]["norm"]),
        causal=False, rope=False))
    return _plus(xs, mlp.mlp_mesh(pl["mlp"], cfg, enc,
                                  _normed(cfg, enc, xs, pl["mlp"]["norm"])))


def run_encoder_mesh(params, cfg: ArchConfig, lay, shards):
    """`run_encoder` on the mesh: each position's batch shard's frames,
    its chunk of F (a layout of F frames, `tp.Layout`), the sinusoidal
    positions of that chunk added; each layer as in `_block_fwd_mesh`
    with bidirectional attention without RoPE; `enc_norm` on each chunk,
    then the output gathered to full F once a position, for the
    decoder's cross attention. Returns each position's (B_loc, F, d)."""
    frames = [s["frames"] for s in shards]
    n_frames = frames[0].shape[1]
    enc = encoder_layout(lay, n_frames)
    pos = common.sinusoidal_positions(n_frames, cfg.d_model,
                                      device=frames[0].device)
    pos = pos[None].to(frames[0].dtype)
    xs = lay.mesh.each(lambda p: enc.local_seq(
        p, frames[lay.shard_of[p]] + pos))
    for i in range(cfg.n_enc_layers):
        xs = _remat(lay.rt, _enc_layer_fwd_mesh, params, i, cfg, enc, xs)
    return _normed(cfg, enc, xs, params["enc_norm"])


def encoder_layout(lay, n_frames: int):
    """The encoder's layout of `n_frames` frames on the path's layout
    `lay` (its runtime: no sequence parallelism while decoding, so
    nothing of the encoder splits there)."""
    return tp.Layout(lay.rt, lay.b_loc * len(lay.groups), n_frames)


def make_extras_mesh(params, cfg: ArchConfig, lay, shards) -> dict:
    """`make_extras` on the mesh: each position's batch shard's `patches`
    (vlm) or encoder output (audio, `run_encoder_mesh`), one entry a
    position."""
    if cfg.family == "vlm":
        return {"patches": lay.mesh.each(
            lambda p: shards[lay.shard_of[p]]["patches"])}
    if cfg.family == "audio":
        return {"enc_out": run_encoder_mesh(params, cfg, lay, shards)}
    return {}


def lm_head_mesh(params, cfg: ArchConfig, lay, xs):
    """The final norm on every position, gathered to full S; the lm head
    then runs once a batch shard, on its representative's rows (on a
    process mesh at every position of the shard, `tp.Layout.held`).
    Returns one (B_loc, S, V) logits tensor a shard of `lay.held()`."""
    h = tp.gather_seq(lay, mesh_mod.pmap(
        lambda _, x: final_norm(params, cfg, x), xs))
    # every column once a batch shard: `unembed` is held whole
    return [h[p] @ tp.take(lay, p, params["unembed"], 1,
                           cfg.padded_vocab).to(h[p].dtype)
            for _, p in lay.held()]


def cross_entropy(logits, labels):
    """Mean token cross-entropy, computed in f32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def cross_tokens(cfg: ArchConfig) -> int:
    """N, the tokens a cross KV holds: the vlm's image patches, whisper's
    encoder frames."""
    return cfg.n_image_tokens if cfg.family == "vlm" else cfg.n_frames


def _sites_below_cut(cfg: ArchConfig) -> int:
    """How many cross sites lie below the split's cut (every site without
    a cut): the vlm's site s closes group s, whisper's is layer s."""
    cut = (cfg.split.cut_layer if cfg.split is not None
           and cfg.split.cut_layer > 0 else cfg.n_layers)
    return cut // cfg.cross_attn_every if cfg.family == "vlm" else cut


@torch.no_grad()
def _cross_kv_cache(params, cfg: ArchConfig, rows: int, extras, device,
                    top=None, part=slice(None)):
    """(rows, sites, 2, 1, n, Hkv, hd): each cross site's (k, v) of the
    rows' image patches (vlm) or encoder output (audio), tokens `part` of
    the N, zeros when `extras` holds none, as in the reference; the
    reference's per-session (sites, 2, 1, N, Hkv, hd) leaf stacked over
    rows. The sites above the cut (`_sites_below_cut`) read `top`'s
    tokens where given (the rows a decode mesh's cut hands over)."""
    if params is None:
        raise ValueError(f"the {cfg.family} cache needs the weights "
                         f"(params=): its cross-attention KV comes from them")
    stack, sub, key = (("cross_layers", "attn", "patches")
                       if cfg.family == "vlm" else
                       ("layers", "cross", "enc_out"))
    zeros = torch.zeros((rows, cross_tokens(cfg), cfg.d_model),
                        dtype=cfg.adtype(), device=device)
    below = _sites_below_cut(cfg)
    sites = []
    for s in range(params[stack][sub]["wk"].shape[0]):
        src = extras if s < below or top is None else top
        tokens = (src or {}).get(key, zeros)[:, part]
        k, v = attention.cross_kv(layer_params(params, s, stack)[sub], cfg,
                                  tokens)
        sites.append(torch.stack([k, v], dim=1)[:, :, None])
    return torch.stack(sites, dim=1)


def init_cache(cfg: ArchConfig, rows: int, max_len: int, device=None,
               bits: int = 16, *, params=None, extras=None):
    """Decode state for `rows` sessions: per-row positions and every
    layer's state (the client fills [0, cut), the server [cut, L)):

      * dense / moe / audio: `kv` of every layer;
      * hybrid: `mamba` {h, conv} of every layer and `kv` of every
        shared-attention site (`attn_sites`);
      * ssm: `rwkv` {S, x_tm, x_cm} of every layer;
      * vlm: `kv` of every self layer;
      * vlm / audio: `cross_kv` (rows, sites, 2, 1, N, Hkv, hd) of every
        cross layer, in the activation dtype whatever `bits`, computed
        from `params` and `extras` (`make_extras` of the rows' batch: the
        patches or the encoder output; zeros without it). Decode reads it
        and never writes it.

    `bits` is the KV cache's width: 16 (the activation dtype) or 8 (int8
    codes and f32 scales, the label owner's arena at `kv_cache_bits=8`)."""
    check_family(cfg)
    L = cfg.n_layers
    cache: Dict[str, Any] = {
        "pos": torch.zeros((rows,), dtype=torch.int64, device=device)}
    if cfg.family == "ssm":
        cache["rwkv"] = rwkv.init_rwkv_cache(cfg, rows, L, device)
        return cache
    if cfg.family == "hybrid":
        cache["mamba"] = ssm.init_mamba_cache(cfg, rows, L, device)
    cache["kv"] = attention.init_kv_cache(cfg, rows, _kv_rings(cfg),
                                          max_len, device, bits=bits)
    if cfg.family in ("vlm", "audio"):
        cache["cross_kv"] = _cross_kv_cache(params, cfg, rows, extras,
                                            device)
    return cache


def _kv_rings(cfg: ArchConfig) -> int:
    """The KV rings a decode cache holds: zamba2's one a shared-attention
    site, the vlm's one a self layer, rwkv6 none, else one a layer."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return sum(s >= 0 for s in attn_sites(cfg))
    if cfg.family == "vlm":
        return cfg.n_layers - cfg.n_layers // cfg.cross_attn_every
    return cfg.n_layers


# decode routes each row alone: a capacity of 1 whatever the factor
DECODE_RT = Runtime(training=False)


def _write_rows(dst, layer: int, new, rows):
    """dst[rows, layer] = new[rows]: a layer's new recurrent state is kept
    for the written rows only, so an inactive arena row does not
    advance."""
    if rows is None:
        dst[:, layer] = new
    else:
        dst[rows, layer] = new[rows]


def _site_kv(cache, site: int):
    """(k, v) (rows, N, Hkv, hd) of cross site `site`."""
    ckv = cache["cross_kv"][:, site]
    return ckv[:, 0, 0], ckv[:, 1, 0]


def decode_layers(params, cfg: ArchConfig, x, cache: Dict[str, Any],
                  lo: int, hi: int, rows=None):
    """One-token pass of x (B, 1, d) through layers [lo, hi), each row at
    its own position `cache["pos"]`. Writes those layers' state in place
    (KV, and the recurrent families' state and conv or token-shift
    history) for `rows` (None = all); the caller advances `pos`. Rows are
    independent: a moe layer routes each row as its own group (the
    reference vmaps one session at a time), so no row takes expert
    capacity from another. A hybrid range without a shared-attention site
    runs its Mamba2 layers alone; a vlm range must hold whole groups
    (`blocks`). Cross attention reads `cache["cross_kv"]`."""
    pos = cache["pos"]
    sites = attn_sites(cfg) if cfg.family == "hybrid" else None
    for kind, layer in blocks(cfg, lo, hi):
        if kind == "cross":
            x = _cross_fwd(layer_params(params, layer, "cross_layers"), cfg,
                           x, kv_cache=_site_kv(cache, layer))
            continue
        pl = layer_params(params, layer)
        if cfg.family == "ssm":
            st = cache["rwkv"]
            x, S, x_tm, x_cm = rwkv.rwkv_decode(
                pl["time"], pl["chan"], x, st["S"][:, layer],
                st["x_tm"][:, layer], st["x_cm"][:, layer])
            for name, new in (("S", S), ("x_tm", x_tm), ("x_cm", x_cm)):
                _write_rows(st[name], layer, new, rows)
            continue
        if cfg.family == "hybrid":
            mc = cache["mamba"]
            y, h, conv = ssm.mamba_decode(
                pl, cfg, _norm(cfg, x, pl["norm"]), mc["h"][:, layer],
                mc["conv"][:, layer])
            _write_rows(mc["h"], layer, h, rows)
            _write_rows(mc["conv"], layer, conv, rows)
            x = x + y
            if sites[layer] >= 0:
                sa, sm = params["shared_attn"], params["shared_mlp"]
                x = x + attention.decode_attention(
                    sa, cfg, _norm(cfg, x, sa["norm"]),
                    attention.layer_kv(cache["kv"], sites[layer]), pos,
                    rows)
                x = x + mlp.mlp(sm, _norm(cfg, x, sm["norm"]))
            continue
        x = x + attention.decode_attention(
            pl["attn"], cfg, _norm(cfg, x, pl["attn"]["norm"]),
            attention.layer_kv(cache["kv"], layer), pos, rows)
        if cfg.family == "audio":
            x = x + attention.cross_attention(
                pl["cross"], cfg, _norm(cfg, x, pl["cross"]["norm"]),
                kv_cache=_site_kv(cache, layer))
        x = x + _ffn(pl, cfg, DECODE_RT, x, per_row=True)[0]
    return x


@torch.no_grad()
def decode_step(params, cfg: ArchConfig, token, cache: Dict[str, Any]):
    """The whole batch's one-token step without a cut: token (B, 1) ->
    (logits (B, 1, V), cache): `embed`, `decode_layers(0, L)`, the final
    norm and the lm head, then every row's position advances by one (the
    reference's `decode_step`, whose rows share one scalar position;
    here every row of `cache["pos"]` starts and stays at the same one).
    The cache (`init_cache`) is written IN PLACE and returned, where the
    reference returns a new one."""
    check_family(cfg)
    x = decode_layers(params, cfg, embed(params, cfg, token), cache, 0,
                      cfg.n_layers)
    cache["pos"] += 1
    return lm_head(params, cfg, x), cache


# ---------------------------------------------------------------------------
# The decode mesh (`tp.Layout(decode=True)`): every family.
# ---------------------------------------------------------------------------

def check_decode_mesh(cfg: ArchConfig):
    """Raise for a config the decode mesh does not run: an unknown family,
    or a vlm whose cut is not whole groups (`blocks`)."""
    check_family(cfg)
    if cfg.split is not None and cfg.split.cut_layer > 0:
        blocks(cfg, 0, cfg.split.cut_layer)


@torch.no_grad()
def init_cache_mesh(cfg: ArchConfig, lay, max_len: int, bits: int = 16, *,
                    params=None, extras=None, top_extras=None):
    """Each position's decode cache on a decode layout `lay`
    (`tp.Layout(decode=True)`), on its device, as `init_cache` lays it
    out for the shard's B_loc rows, "size" the ring's slots (an int); on
    a process mesh the process's own position's only, None at the
    others:

      * "kv": the rings of every attention layer or site (`init_cache`).
        With flash decode (`lay.ring_split(size)`) position r of a 'model'
        group of m holds slots [r * size / m, (r + 1) * size / m); else
        every position holds the whole ring.
      * "mamba" (hybrid) and "rwkv" (ssm): with the heads split over
        'model' (`lay.split`) each position's heads only
        (`ssm.init_mamba_cache(heads=)`, `rwkv.init_rwkv_cache(heads=)`),
        else every head; the token shifts whole.
      * "cross_kv" (vlm, audio; `params` needed): (B_loc, sites, 2, 1, n,
        Hkv, hd), every cross site's k and v of position r's tokens
        [r * n, (r + 1) * n) with the N tokens split (`lay.ring_split(N)`,
        n = N / m), else of all N, from `extras` (`make_extras_mesh`'s,
        each position's own rows) below the cut and `top_extras` (the
        rows the cut hands the position, `split.model.
        init_decode_cache`) above it; zeros without them.

    Layers [0, cut) hold the shard's own rows, layers [cut, L) the rows
    the cut hands it (another pod's, on the pod ring:
    `split.model.decode_step`)."""
    check_decode_mesh(cfg)
    L, m = cfg.n_layers, lay.n_model
    size = min(max_len, cfg.sliding_window) if cfg.sliding_window \
        else max_len
    slots = size // m if lay.ring_split(size) else size
    n_kv = _kv_rings(cfg)

    def build(p):
        dev = lay.mesh.devices[p]
        c = {"pos": torch.zeros((lay.b_loc,), dtype=torch.int64,
                                device=dev), "size": size}
        if n_kv:
            c["kv"] = attention.init_kv_cache(cfg, lay.b_loc, n_kv, slots,
                                              dev, bits=bits)
        if cfg.family == "hybrid":
            H = cfg.ssm_heads
            c["mamba"] = ssm.init_mamba_cache(
                cfg, lay.b_loc, L, dev, heads=H // m if lay.split(H) else H)
        elif cfg.family == "ssm":
            H = cfg.d_model // rwkv.HD
            c["rwkv"] = rwkv.init_rwkv_cache(
                cfg, lay.b_loc, L, dev, heads=H // m if lay.split(H) else H)
        elif cfg.family in ("vlm", "audio"):
            N = cross_tokens(cfg)
            n = N // m if lay.ring_split(N) else N
            r = lay.rank(p) if n < N else 0
            c["cross_kv"] = _cross_kv_cache(
                params, cfg, lay.b_loc, _at(extras, p), dev,
                _at(top_extras, p), slice(r * n, (r + 1) * n))
        return c

    return lay.mesh.each(build)


def _at(extras, p: int):
    """Position `p`'s entries of per-position extras (None stays None)."""
    return extras and {k: v[p] for k, v in extras.items()}


def cross_split(cfg: ArchConfig, lay) -> bool:
    """Whether a decode layout's cross KV splits its N tokens over
    'model' (flash decode, `tp.Layout.ring_split`)."""
    return (cfg.family in ("vlm", "audio")
            and lay.ring_split(cross_tokens(cfg)))


def decode_layers_mesh(params, cfg: ArchConfig, lay, xs, caches, lo: int,
                       hi: int):
    """`decode_layers` on a decode mesh: xs holds each position's (B_loc,
    1, d) residual, whole (equal over each 'model' group), caches each
    position's (`init_cache_mesh`). It walks `blocks(cfg, lo, hi)` as
    `decode_layers` does: attention is `attention.decode_attention_mesh`,
    cross attention `attention.cross_decode_mesh` over the cache's cross
    KV, the MLP `mlp.mlp_mesh` (gated in the vlm's cross layers), the
    experts `moe.moe_mesh` (each row its own group), Mamba2
    `ssm.mamba_decode_mesh` (then zamba2's shared attention and MLP at a
    site) and RWKV6 `rwkv.rwkv_decode_mesh`, their partial outputs summed
    over 'model'; each layer's new recurrent state is written for every
    row. With a 'model' of 1 every position computes what
    `decode_layers` computes on its rows."""
    check_decode_mesh(cfg)
    pmap = mesh_mod.pmap
    rings = (pmap(lambda p, c: attention.decode_ring(
        cfg, lay, p, c["pos"], c["size"], c["kv"]["k"].shape[3]), caches)
        if "kv" in mesh_mod.first(caches) else None)
    split_n = cross_split(cfg, lay)
    sites = attn_sites(cfg) if cfg.family == "hybrid" else None

    def normed(p):
        return pmap(lambda _, x: _norm(cfg, x, p), xs)

    def attend(pa, kv_index):
        return attention.decode_attention_mesh(
            pa, cfg, lay, normed(pa["norm"]),
            pmap(lambda _, c: attention.layer_kv(c["kv"], kv_index), caches),
            rings)

    def cross(pa, site, gated=False):
        return attention.cross_decode_mesh(
            pa, cfg, lay, normed(pa["norm"]),
            pmap(lambda _, c: _site_kv(c, site), caches), split_n,
            gated=gated)

    def write(states, name, layer, vals):
        for st, val in zip(states, vals):
            if st is not None:
                _write_rows(st[name], layer, val, None)

    for kind, layer in blocks(cfg, lo, hi):
        if kind == "cross":
            pl = layer_params(params, layer, "cross_layers")
            xs = _plus(xs, cross(pl["attn"], layer, gated=True))
            xs = _plus(xs, mlp.mlp_mesh(pl["mlp"], cfg, lay,
                                        normed(pl["mlp"]["norm"]),
                                        gated=True))
            continue
        pl = layer_params(params, layer)
        if cfg.family == "ssm":
            sts = pmap(lambda _, c: c["rwkv"], caches)
            xs, *new = rwkv.rwkv_decode_mesh(
                pl["time"], pl["chan"], cfg, lay, xs,
                *(pmap(lambda _, st, n=n: st[n][:, layer], sts)
                  for n in ("S", "x_tm", "x_cm")))
            for name, vals in zip(("S", "x_tm", "x_cm"), new):
                write(sts, name, layer, vals)
            continue
        if cfg.family == "hybrid":
            mcs = pmap(lambda _, c: c["mamba"], caches)
            ys, hs, convs = ssm.mamba_decode_mesh(
                pl, cfg, lay, normed(pl["norm"]),
                pmap(lambda _, mc: mc["h"][:, layer], mcs),
                pmap(lambda _, mc: mc["conv"][:, layer], mcs))
            write(mcs, "h", layer, hs)
            write(mcs, "conv", layer, convs)
            xs = _plus(xs, ys)
            if sites[layer] >= 0:
                xs = _plus(xs, attend(params["shared_attn"], sites[layer]))
                sm = params["shared_mlp"]
                xs = _plus(xs, mlp.mlp_mesh(sm, cfg, lay,
                                            normed(sm["norm"])))
            continue
        xs = _plus(xs, attend(pl["attn"], layer))
        if cfg.family == "audio":
            xs = _plus(xs, cross(pl["cross"], layer))
        if cfg.family == "moe":
            ys, _ = moe.moe_mesh(pl["moe"], cfg, lay,
                                 normed(pl["moe"]["norm"]))
        else:
            ys = mlp.mlp_mesh(pl["mlp"], cfg, lay, normed(pl["mlp"]["norm"]))
        xs = _plus(xs, ys)
    return xs


def lm_head_decode_mesh(params, cfg: ArchConfig, lay, xs):
    """The final norm and the lm head on every position of a decode mesh:
    its 'model' shard of the padded vocab (columns [r * V / m, (r + 1) *
    V / m) at 'model' index r) where 'model' divides it (`lay.split`),
    else every column. Returns each position's (B_loc, 1, V or V / m)
    logits."""
    V = cfg.padded_vocab
    c = V // lay.n_model if lay.split(V) else V

    def head(p, x):
        h = final_norm(params, cfg, x)
        return h @ tp.take(lay, p, params["unembed"], 1, c).to(h.dtype)

    return mesh_mod.pmap(head, xs)
