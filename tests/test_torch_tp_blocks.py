"""TP-local 'model' blocks (`launch.specs.use_layouts`, `models.tp.take`)
on the CPU, in one process, on `meta` where nothing runs.

  * `use_layouts` resolves for every family x path ("train", "decode",
    "arena") x mesh (1, 2), (2, 2), (1, 4), (2, 1, 2) and `dp_only` (2,
    2): a tree shaped like `param_shardings`, each 'model' entry one that
    the rest layout splits over 'model' too, whole under `dp_only`; the
    leaves the path reads whole (`embed`, training's `unembed`, Mamba2's
    `w_xz`, decode's wk and wv, flash decode's wq, the wk and wv of
    fewer k/v heads than 'model' positions) are whole; for each family,
    path and mesh the procs tests run, the leaves held as blocks are the
    ones written out by hand (`PINNED`);
  * `tp.take`: a whole leaf sliced at the position's 'model' rank, a held
    block passed as it is, any other size raised;
  * the single controller at SMOKE in f32 with every leaf that
    `use_layouts` holds as a 'model' block replaced by its blocks, one a
    'model' rank (`_Blocks`: `tp.take` hands a position its rank's block,
    which it passes only if it is what the position reads; any other read
    of such a leaf fails), computes what it computes on whole leaves, bit
    for bit: the training forward's logits and balance loss, the decode
    step's logits and serve step's tokens (with the cross KV its cache
    builds from the same leaves), and the sharded arena step's tokens,
    for every family at (2, 2), (1, 4) and (2, 1, 2);
  * a leaf held as a block where the path reads it whole raises;
  * the forward on blocks against the JAX package's mesh-less forward
    (yi-6b, the reference's weights): within 1e-4;
  * the dry run's per-device parameter bytes of a train and a decode step
    (`launch.dryrun.device_use_bytes`) are the use blocks' bytes, below
    the whole parameters' where a leaf is held as a block, and
    `procs_step_bytes` reckons a process's train step.

The process mesh holds these blocks across processes:
`tests/test_torch_mesh_procs.py`, `test_torch_mesh_procs_families.py`,
`test_torch_decode_mesh_procs.py` and `test_torch_arena_procs.py`.
"""
from __future__ import annotations

import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import transformer as jtr
from repro.models.config import Runtime as JRuntime
from repro_torch import configs
from repro_torch import mesh as mesh_mod
from repro_torch.launch import dryrun, specs, steps
from repro_torch.launch.mesh import make_mesh, make_serving_mesh
from repro_torch.models import convert, tp, transformer
from repro_torch.models.config import Runtime, SplitConfig
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.runtime import steps as rsteps
from repro_torch.runtime.arena import SlotArena
from repro_torch.split import model as split_model

FAMILY_ARCHS = ["yi-6b", "qwen3-8b", "granite-moe-1b-a400m", "zamba2-7b",
                "rwkv6-1.6b", "llama-3.2-vision-90b", "whisper-tiny"]
AXES2, AXES3 = ("data", "model"), ("pod", "data", "model")
RESOLVE_MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4),
                  "2x1x2": (2, 1, 2), "dp_only": (2, 2)}
RUN_MESHES = {"2x2": (2, 2), "1x4": (1, 4), "2x1x2": (2, 1, 2)}
B, S, MAX_LEN, DECODE_STEPS, K = 4, 16, 8, 3, 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _axes(shape):
    return AXES3 if len(shape) == 3 else AXES2


def _cfg(arch, split=True):
    cfg = configs.get(arch, smoke=True)
    if not split:
        return cfg
    return cfg.with_(split=SplitConfig(cut_layer=configs.cut_for(cfg),
                                       compressor="randtopk", k=K))


def _rt(shape, **kw):
    return Runtime(mesh=make_mesh(shape, _axes(shape), devices="cpu"), **kw)


class _Blocks:
    """A leaf held as its 'model' blocks, one a 'model' rank: the single
    controller's stand-in for what the processes hold. Indexing (a
    layer of the stack) indexes every block; `tp.take` (`_blocked`)
    hands a position its rank's block. Any other use fails."""

    def __init__(self, blocks):
        self.blocks = blocks

    def __getitem__(self, i):
        return _Blocks([b[i] for b in self.blocks])


@contextlib.contextmanager
def _blocked():
    """`tp.take` reading a `_Blocks` leaf: the position's rank's block,
    which `take` passes as it is where it is what the position reads, and
    raises on else (a block is never the whole leaf)."""
    take = tp.take

    def blocked(lay, p, w, dim, n):
        if isinstance(w, _Blocks):
            mesh = lay if isinstance(lay, mesh_mod.Mesh) else lay.mesh
            w = w.blocks[mesh.coord(p, "model")]
        return take(lay, p, w, dim, n)

    tp.take = blocked
    try:
        yield
    finally:
        tp.take = take


def _as_blocks(params, uses, mesh):
    """`params` with every leaf its use layout holds over 'model' as its
    blocks (copies), one a 'model' rank."""
    reps = {mesh.coord(p, "model"): p for p in range(mesh.size)}

    def convert_(t, use):
        if "model" not in use:
            return t
        return _Blocks([t[mesh_mod.block_slices(mesh, reps[r], use,
                                                t.shape)].clone()
                        for r in range(len(reps))])

    return tree_map(convert_, params, uses)


def _n_blocks(uses):
    return sum("model" in u for u in tree_leaves(uses))


def _params(cfg, seed=0):
    params = transformer.init_model(cfg, torch.Generator().manual_seed(seed))
    for sub in params.values():       # the cross gates open, so they count
        if isinstance(sub, dict):
            for leaf in sub.values():
                if isinstance(leaf, dict) and "gate" in leaf:
                    leaf["gate"].fill_(0.5)
    return params


def _batch(cfg, seq=S, seed=11):
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, cfg.vocab, (B, seq))
    out = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(
        np.roll(tok, -1, axis=1))}
    side = _side(cfg, rng)
    return dict(out, **side) if side else out


def _side(cfg, rng=None):
    rng = rng or np.random.RandomState(7)
    name = {"vlm": "patches", "audio": "frames"}.get(cfg.family)
    if name is None:
        return None
    return {name: torch.from_numpy((rng.randn(
        B, transformer.cross_tokens(cfg), cfg.d_model) * 0.02).astype(
        np.float32))}


# ---------------------------------------------------------------------------
# use_layouts resolves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_id", list(RESOLVE_MESHES))
@pytest.mark.parametrize("path", specs.USE_PATHS)
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_use_layouts_resolve(arch, path, mesh_id):
    """A use layout is the rest layout with every axis but 'model'
    dropped, or whole; whole under dp_only and for the leaves the path
    reads whole."""
    cfg = configs.get(arch, smoke=True)
    shape = RESOLVE_MESHES[mesh_id]
    mesh = make_mesh(shape, _axes(shape), devices="meta")
    rt = Runtime(mesh=mesh, dp_only=mesh_id == "dp_only")
    whole = specs.abstract_params(cfg)
    store = specs.param_shardings(cfg, rt, whole)
    uses = specs.use_layouts(cfg, rt, path)
    assert tree_map(lambda *_: 0, uses) == tree_map(lambda *_: 0, store)
    for use, lay in zip(tree_leaves(uses), tree_leaves(store)):
        assert len(use) == len(lay)
        for u, e in zip(use, lay):
            assert u in (None, "model")
            if u == "model":
                assert "model" in specs._entry_axes(e)
    if mesh_id == "dp_only":
        assert _n_blocks(uses) == 0
        return
    assert "model" not in uses["embed"]
    if path == "train":
        assert "model" not in uses["unembed"]
    if path == "arena":
        assert _n_blocks(uses) == 1 and "model" in uses["unembed"]
    if cfg.family == "hybrid":
        assert "model" not in uses["layers"]["w_xz"]
    if path == "decode" and "attn" in uses.get("layers", {}):
        att = uses["layers"]["attn"]
        assert "model" not in att["wk"] and "model" not in att["wv"]
        assert "model" not in att["wq"]          # flash decode: q whole
    if (path == "train" and "attn" in uses.get("layers", {})
            and cfg.n_kv_heads % shape[-1]):
        att = uses["layers"]["attn"]
        assert "model" not in att["wk"] and "model" not in att["wv"]


def test_use_layouts_take_what_the_step_reads():
    """yi-6b at full width, (2, 2): in training every layer matrix is held
    as its 'model' half (its 4 k/v heads split), embed and unembed whole;
    decoding holds wo, the MLP and unembed's columns; the arena unembed's
    columns only; a sequence 'model' does not divide splits nothing."""
    cfg = configs.get("yi-6b")
    rt = Runtime(mesh=make_mesh((2, 2), AXES2, devices="meta"))
    layer = {"attn": ("wq", "wk", "wv", "wo"),
             "mlp": ("w_gate", "w_up", "w_down")}

    def held(uses):
        return sorted("/".join(k) for k, u in _keyed(uses) if "model" in u)

    assert held(specs.use_layouts(cfg, rt, "train")) == sorted(
        f"layers/{b}/{n}" for b, names in layer.items() for n in names)
    assert held(specs.use_layouts(cfg, rt, "decode")) == sorted(
        ["layers/attn/wo", "unembed"]
        + [f"layers/mlp/{n}" for n in layer["mlp"]])
    assert held(specs.use_layouts(cfg, rt, "arena")) == ["unembed"]
    assert held(specs.use_layouts(cfg, rt, "train", seq=15)) == []
    assert held(specs.use_layouts(cfg, Runtime(
        mesh=rt.mesh, flash_decode=False), "decode")) == sorted(
        ["layers/attn/wq", "layers/attn/wo", "unembed"]
        + [f"layers/mlp/{n}" for n in layer["mlp"]])
    with pytest.raises(ValueError, match="use layouts"):
        specs.use_layouts(cfg, rt, "prefill")


def _keyed(tree, key=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _keyed(v, key + (k,))
    else:
        yield key, tree


def _leaves(prefix, names):
    return {f"{prefix}/{n}" for n in names}


_ATTN, _ATTN_QO = ("wq", "wk", "wv", "wo"), ("wq", "wo")
_MLP, _TIME = ("w_gate", "w_up", "w_down"), ("w_r", "w_k", "w_v", "w_g",
                                            "w_out")
_MAMBA = _leaves("layers", ("conv_x", "norm_g/scale", "w_out"))
_RWKV = _leaves("layers/time", _TIME) | _leaves("layers/chan",
                                                ("w_k", "w_v"))
# The leaves held as 'model' blocks on each path the procs tests run, by
# 'model' size, worked out by hand from the model code's reads at SMOKE
# widths (4 q heads and 2 k/v heads, zamba2's shared block and rwkv6 4
# and 4; d_ff 512 (the moe 128, 4 experts); vocab 512; zamba2 16 Mamba2
# heads, rwkv6 4 WKV heads; whisper 2 heads, 2 k/v heads, 16 frames),
# a training sequence of 16 and flash decode:
#   train: wq, wo where 'model' divides the q heads; wk, wv where it
#     divides the k/v heads too; the MLP, the experts, Mamba2's conv_x,
#     norm_g and w_out, RWKV6's projections; never embed, unembed, w_xz;
#   decode: wo and the MLP (wq, wk, wv whole: flash decode, every k/v
#     head), unembed's columns; whisper's encoder whole (no sequence
#     parallelism while decoding);
#   arena: unembed's columns where 'model' has two positions or more.
PINNED = {
    ("yi-6b", "train", 2): _leaves("layers/attn", _ATTN)
    | _leaves("layers/mlp", _MLP),
    ("granite-moe-1b-a400m", "train", 2): _leaves("layers/attn", _ATTN)
    | _leaves("layers/moe", _MLP),
    ("zamba2-7b", "train", 2): _MAMBA | _leaves("shared_attn", _ATTN)
    | _leaves("shared_mlp", _MLP),
    ("rwkv6-1.6b", "train", 2): _RWKV,
    ("llama-3.2-vision-90b", "train", 2): _leaves("layers/attn", _ATTN)
    | _leaves("layers/mlp", _MLP) | _leaves("cross_layers/attn", _ATTN)
    | _leaves("cross_layers/mlp", _MLP),
    ("whisper-tiny", "train", 2): _leaves("enc_layers/attn", _ATTN)
    | _leaves("enc_layers/mlp", _MLP) | _leaves("layers/attn", _ATTN)
    | _leaves("layers/cross", _ATTN) | _leaves("layers/mlp", _MLP),
    **{("yi-6b", "decode", m): {"layers/attn/wo", "unembed"}
       | _leaves("layers/mlp", _MLP) for m in (2, 4)},
    **{("granite-moe-1b-a400m", "decode", m): {"layers/attn/wo", "unembed"}
       | _leaves("layers/moe", _MLP) for m in (2, 4)},
    **{("zamba2-7b", "decode", m): _MAMBA | {"shared_attn/wo", "unembed"}
       | _leaves("shared_mlp", _MLP) for m in (2, 4)},
    **{("rwkv6-1.6b", "decode", m): _RWKV | {"unembed"} for m in (2, 4)},
    **{("llama-3.2-vision-90b", "decode", m): {
        "layers/attn/wo", "cross_layers/attn/wo", "unembed"}
       | _leaves("layers/mlp", _MLP) | _leaves("cross_layers/mlp", _MLP)
       for m in (2, 4)},
    # at 'model' 4 whisper's 2 heads do not split: the MLP only
    ("whisper-tiny", "decode", 2): {"layers/attn/wo", "layers/cross/wo",
                                    "unembed"} | _leaves("layers/mlp", _MLP),
    ("whisper-tiny", "decode", 4): {"unembed"} | _leaves("layers/mlp", _MLP),
    **{(a, "arena", m): {"unembed"} if m > 1 else set()
       for a in ("qwen3-8b", "rwkv6-1.6b") for m in (1, 2)},
}
# the procs tests' meshes of each path
PROCS_MESHES = {"train": {"1x2": (1, 2), "2x2": (2, 2), "2x1x2": (2, 1, 2)},
                "decode": {"2x2": (2, 2), "1x4": (1, 4), "2x1x2": (2, 1, 2)},
                "arena": {"4x1": (4, 1), "2x2": (2, 2), "2x1x2": (2, 1, 2)}}


@pytest.mark.parametrize("arch,path,mesh_id", [
    (a, path, mid) for (a, path, m) in PINNED
    for mid, shape in PROCS_MESHES[path].items() if shape[-1] == m
    and not (path == "train" and mid == "1x2"
             and a not in ("yi-6b", "granite-moe-1b-a400m"))])
def test_held_leaves_are_pinned(arch, path, mesh_id):
    """The leaves `use_layouts` holds as 'model' blocks, for each family
    and path the procs tests run, are the ones the model code reads as
    blocks (`PINNED`): a leaf kept whole where a position reads only its
    block fails here (the held-bytes checks compare the bytes a step
    holds with the same layouts, so they cannot see it)."""
    shape = PROCS_MESHES[path][mesh_id]
    rt = Runtime(mesh=make_mesh(shape, _axes(shape), devices="meta"),
                 flash_decode=True)
    uses = specs.use_layouts(_cfg(arch), rt, path, seq=S)
    got = {"/".join(k) for k, u in _keyed(uses) if "model" in u}
    assert got == PINNED[arch, path, shape[-1]]


# ---------------------------------------------------------------------------
# tp.take
# ---------------------------------------------------------------------------

def test_take_slices_passes_and_raises():
    lay = tp.Layout(_rt((1, 4)), 4, 8)
    w = torch.arange(3 * 8).reshape(3, 8)
    for p in range(4):                     # a whole leaf: the rank's slice
        got = tp.take(lay, p, w, 1, 2)
        assert torch.equal(got, w[:, 2 * p:2 * p + 2])
        assert got.data_ptr() == w[:, 2 * p:].data_ptr()   # a view
    blk = w[:, 4:6].clone()                # a held block: as it is
    assert tp.take(lay, 2, blk, 1, 2) is blk
    assert tp.take(lay, 1, w, 1, 8) is w   # a whole leaf read whole
    with pytest.raises(ValueError, match="neither the whole leaf"):
        tp.take(lay, 1, blk, 1, 8)         # a block read whole
    with pytest.raises(ValueError, match="neither the whole leaf"):
        tp.take(lay, 1, w[:, :4], 1, 2)    # neither
    one = tp.Layout(_rt((2, 1)), 4, 8)     # 'model' of 1: the leaf
    assert torch.equal(tp.take(one, 1, w, 1, 8), w)
    serving = make_serving_mesh(4, model=2, devices="cpu")
    assert torch.equal(tp.take(serving, 3, w, 1, 4), w[:, 4:])


# ---------------------------------------------------------------------------
# the single controller on blocks = on whole leaves, bit for bit
# ---------------------------------------------------------------------------

def _forward(cfg, rt, params, batch):
    with torch.no_grad():
        logits, aux = split_model.forward(
            params, cfg, rt, batch, generator=torch.Generator().manual_seed(3))
    return list(logits), aux


def _decode(cfg, rt, params):
    """`DECODE_STEPS` of the serve step's tokens, and the decode step's
    logits fed them, each chain from its own cache (the cross KV built
    from `params`)."""
    lay = split_model.decode_layout(cfg, rt, B)
    side = _side(cfg)
    caches = [split_model.init_decode_cache(params, cfg, lay, MAX_LEN,
                                            side=side) for _ in range(2)]
    serve = steps.make_serve_step(cfg, rt)
    tok = torch.from_numpy(np.random.RandomState(5).randint(
        0, cfg.vocab, (B, 1)))
    toks, logits = [], []
    for _ in range(DECODE_STEPS):
        logits.append(split_model.decode_step(params, cfg, rt, tok,
                                              caches[1])[0])
        tok, _ = serve(params, caches[0], tok)
        toks.append(tok)
    return torch.cat(toks, 1), logits


def _arena(cfg, mesh, params):
    """Two steps of the sharded arena step over 8 rows (all active, then
    every other one): the tokens."""
    cap = 8
    arena = SlotArena(lambda rows: transformer.init_cache(
        cfg, rows, MAX_LEN, params=params), cap, (1, 1, cfg.d_model),
        torch.float32, "cpu", mesh=mesh)
    step = rsteps.make_arena_top_step(cfg, configs.cut_for(cfg), mesh=mesh)
    rng = np.random.RandomState(0)
    out = []
    for active in (np.ones(cap, bool), np.array([True, False] * 4)):
        arena.xbuf.copy_(torch.from_numpy(rng.randn(
            *arena.xbuf.shape).astype(np.float32)))
        out.append(step(params, arena.xbuf, arena.cache, active))
    return out


@pytest.fixture(scope="module", params=FAMILY_ARCHS)
def model(request):
    cfg = _cfg(request.param)
    return cfg, _params(cfg)


@pytest.mark.parametrize("mesh_id", list(RUN_MESHES))
def test_forward_on_blocks_is_the_whole_forward(model, mesh_id):
    cfg, params = model
    rt = _rt(RUN_MESHES[mesh_id])
    uses = specs.use_layouts(cfg, rt, "train", seq=S)
    batch = _batch(cfg)
    want = _forward(cfg, rt, params, batch)
    with _blocked():
        got = _forward(cfg, rt, _as_blocks(params, uses, rt.mesh), batch)
    assert len(got[0]) == len(want[0])
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    assert torch.equal(got[1], want[1])
    if mesh_id == "2x2":
        assert _n_blocks(uses)


@pytest.mark.parametrize("mesh_id", list(RUN_MESHES))
def test_decode_on_blocks_is_the_whole_decode(model, mesh_id):
    cfg, params = model
    rt = _rt(RUN_MESHES[mesh_id], training=False, moe_capacity=8.0)
    uses = specs.use_layouts(cfg, rt, "decode")
    toks, logits = _decode(cfg, rt, params)
    with _blocked():
        got_toks, got_logits = _decode(cfg, rt, _as_blocks(params, uses,
                                                           rt.mesh))
    assert torch.equal(got_toks, toks)
    for a, b in zip(got_logits, logits):
        assert torch.equal(a, b)
    assert _n_blocks(uses)


@pytest.mark.parametrize("mesh_id", list(RUN_MESHES))
def test_arena_on_blocks_is_the_whole_arena(model, mesh_id):
    cfg, params = model
    shape = RUN_MESHES[mesh_id]
    mesh = make_serving_mesh(4, model=shape[-1],
                             pod=shape[0] if len(shape) == 3 else 1,
                             devices="cpu")
    uses = specs.use_layouts(cfg, Runtime(mesh=mesh), "arena")
    want = _arena(cfg, mesh, params)
    with _blocked():
        got = _arena(cfg, mesh, _as_blocks(params, uses, mesh))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert _n_blocks(uses) == 1


@pytest.mark.parametrize("path,leaf", [
    ("train", ("embed",)), ("train", ("unembed",)),
    ("decode", ("layers", "attn", "wk")), ("decode", ("layers", "attn",
                                                        "wq")),
    ("decode", ("embed",))])
def test_a_block_read_whole_raises(path, leaf):
    """A leaf held as a block where the path reads all of it fails in
    `tp.take`."""
    cfg = _cfg("yi-6b")
    params = _params(cfg)
    mesh_shape = (2, 2)
    rt = _rt(mesh_shape, training=path == "train")
    uses = specs.use_layouts(cfg, rt, path, seq=S)
    wrong = specs.param_shardings(cfg, rt, params)
    node = uses
    for k in leaf[:-1]:
        node = node[k]
    store = wrong
    for k in leaf:
        store = store[k]
    node[leaf[-1]] = tuple(e if e == "model" else None for e in store)
    blocks = _as_blocks(params, uses, rt.mesh)
    with _blocked(), pytest.raises(ValueError, match="neither the whole"):
        if path == "train":
            _forward(cfg, rt, blocks, _batch(cfg))
        else:
            _decode(cfg, rt, blocks)


def test_forward_on_blocks_matches_the_reference():
    """yi-6b SMOKE without a cut, the reference's weights, on blocks at
    (2, 2): the logits within 1e-4 of the JAX package's mesh-less
    forward."""
    arch = "yi-6b"
    jcfg = jconfigs.get(arch, smoke=True)
    cfg = _cfg(arch, split=False)
    jp = jtr.init_model(jax.random.key(0), jcfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                     "cpu")
    batch = _batch(cfg)
    want, _ = jax.jit(lambda p, t: jtr.forward(
        p, jcfg, JRuntime(training=False), {"tokens": t}))(
        jp, jnp.asarray(batch["tokens"].numpy(), dtype=jnp.int32))
    rt = _rt((2, 2))
    with _blocked():
        got, _ = _forward(cfg, rt, _as_blocks(
            params, specs.use_layouts(cfg, rt, "train", seq=S), rt.mesh),
            batch)
    np.testing.assert_allclose(torch.cat(got).numpy(), np.asarray(want),
                               rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# the dry run's per-device parameter bytes of a step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("arch", ["yi-6b", "qwen3-moe-235b-a22b",
                                  "llama-3.2-vision-90b"])
def test_dry_run_step_param_bytes_are_the_use_blocks(arch, kind):
    """At (16, 16) on `meta`: the bytes of a device's use blocks, between
    its rest blocks' and the whole parameters'."""
    cfg = configs.get(arch)
    mesh = make_mesh((16, 16), AXES2, devices="meta")
    rt = Runtime(mesh=mesh)
    whole = specs.abstract_params(cfg)
    path = "train" if kind == "train" else "decode"
    uses = specs.use_layouts(cfg, rt, path)
    want = specs.block_bytes(whole, uses, mesh.shape)
    got = dryrun.device_use_bytes(cfg, mesh, kind)
    assert got == want
    rest = specs.block_bytes(whole, specs.param_shardings(cfg, rt, whole),
                             mesh.shape)
    full = sum(t.numel() * t.element_size() for t in tree_leaves(whole))
    assert rest < got < full
    by_hand = sum(t.numel() // math.prod(
        mesh.shape[a] for a in u if a is not None) * t.element_size()
        for t, u in zip(tree_leaves(whole), tree_leaves(uses)))
    assert got == by_hand


def test_procs_step_bytes_reckon_a_process_step():
    """`launch.dryrun.procs_step_bytes`: a process's held and sent bytes
    of a train step at (2, 2); the gather sends the use blocks less the
    rest blocks, less than the whole gather, and the reduce less than the
    whole-world one."""
    cfg = configs.get("yi-6b", smoke=True)
    mesh = make_mesh((2, 2), AXES2, devices="meta")
    got = dryrun.procs_step_bytes(cfg, mesh, S)
    assert got["gather_sent"] == got["held"] - got["rest"]
    assert got["gather_sent"] < got["whole_gather_sent"]
    assert got["reduce_sent"] < got["whole_reduce_sent"]
    assert got["held"] < got["whole_held"]
    assert got["decode_held"] == dryrun.device_use_bytes(cfg, mesh, "decode")
