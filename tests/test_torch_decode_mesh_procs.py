"""The whole-batch serve step on a decode mesh across processes
(`mesh.ProcessMesh`, `launch.mesh.spawn`) on the CPU over gloo, against
the single controller's decode mesh and the JAX package.

Every family at SMOKE in f32, split randtopk k 16 (TopK at inference)
at `test_torch_decode_mesh_families.py`'s cuts: yi-6b and
granite-moe-1b-a400m (cut 1), zamba2-7b (cut 2), rwkv6-1.6b (cut 1),
llama-3.2-vision-90b (cut 2, every gate at 0.5, the caches of the rows'
patches) and whisper-tiny (cut 1, the caches of the rows' encoder
output), from the reference's weights (`models.convert`). B 4, flash
decode on, 14 steps that wrap a 12-slot ring, two chains a config: the
serve step's greedy tokens (`launch.steps.make_serve_step`), and
`split.model.decode_step` fed those tokens. Each mesh is spawned once,
4 processes at ('data', 'model') (2, 2) and (1, 4) and at ('pod',
'data', 'model') (2, 1, 2) (the pod ring: whisper's encoder output
crosses it as the caches are built, `next_tokens` takes its inverse),
every process on one torch thread. On every rank:

  * every token and every logit equal the single controller's decode
    mesh's at the same shape, bit for bit;
  * the counted collective bytes of every step equal
    `roofline.analysis.decode_collective_costs` (with the argmax for the
    serve step, without for `decode_step`: the fetch of every row's
    token or logits is not counted), and a cache's
    `decode_cache_collective_costs`;
  * rwkv6-1.6b and whisper-tiny again at B 1, which the batch shards of
    (2, 2) and (2, 1, 2) do not divide (`tp.Layout.whole`: every shard
    holds the row), to the same two checks;
  * the first 3 steps' logits lie within 1e-4 (rwkv6 1e-3, the f32
    conditioning both packages share) of the JAX package's mesh-less
    `repro.split.model.decode_step` fed the same tokens, and their
    greedy tokens are equal (as `test_torch_decode_mesh_families.py`
    holds the single controller);
  * each rank decodes on its use blocks (`launch.specs.use_layouts(...,
    "decode")`, made once before the first token with
    `specs.shard_tree`, its cache's cross KV read from them): their
    bytes are `specs.block_bytes` of the use layouts, below the whole
    parameters'.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import transformer as jtr
from repro.models.config import Runtime as JRuntime
from repro.models.config import SplitConfig as JSplit
from repro.split import model as jsplit_model
from test_torch_multimodal import set_gates
from repro_torch import configs
from repro_torch import mesh as mesh_mod
from repro_torch.launch import specs, steps
from repro_torch.launch.mesh import make_mesh, make_process_mesh, spawn
from repro_torch.mesh import collective_bytes
from repro_torch.models.config import Runtime, SplitConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.optim.adamw import tree_leaves
from repro_torch.roofline import analysis
from repro_torch.split import model as split_model

# (arch, cut)
ARCHS = {"yi-6b": 1, "granite-moe-1b-a400m": 1, "zamba2-7b": 2,
         "rwkv6-1.6b": 1, "llama-3.2-vision-90b": 2, "whisper-tiny": 1}
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
B, MAX_LEN, STEPS = 4, 12, 14
REF_STEPS, REF_ATOL = 3, {"rwkv6-1.6b": 1e-3}
WHOLE = ("rwkv6-1.6b", "whisper-tiny")   # also served at B 1
JOIN_S = 240


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch):
    return configs.get(arch, smoke=True).with_(split=SplitConfig(
        cut_layer=ARCHS[arch], compressor="randtopk", k=16))


def _side(cfg, batch=B):
    """The rows' patches (vlm) or frames (whisper), N(0, 1) * 0.02."""
    if cfg.family not in ("vlm", "audio"):
        return None
    name, n = (("patches", cfg.n_image_tokens) if cfg.family == "vlm"
               else ("frames", cfg.n_frames))
    return {name: (np.random.RandomState(7).randn(batch, n, cfg.d_model)
                   * 0.02).astype(np.float32)}


def _prompt(cfg, batch=B):
    return np.random.RandomState(5).randint(0, cfg.vocab, (batch, 1))


def _serve(arch, params, mesh, batch=B):
    """The serve chain of `STEPS` tokens on `mesh`, then `decode_step`
    fed its first `REF_STEPS` tokens, each with its own cache and
    registry (`rt.moe_capacity` 8.0 for the moe): (the serve step's
    tokens (B, STEPS), each serve step's per-position last logits (None
    where the process has none), `decode_step`'s logits (B, 1, V) a
    step, the serve chain's counted bytes a step, the decode chain's,
    one cache's build, the bytes of the params decoded with: on a
    process mesh the process's use blocks)."""
    cfg, side = _cfg(arch), _side(_cfg(arch), batch)
    side = side and {k: torch.from_numpy(v) for k, v in side.items()}
    regs = [MetricsRegistry() for _ in range(3)]
    rts = [Runtime(training=False, mesh=mesh, registry=reg,
                   flash_decode=True, moe_capacity=8.0) for reg in regs]
    if mesh.procs:
        params = specs.shard_tree(mesh, params, specs.use_layouts(
            cfg, rts[0], "decode", params))
    lay = split_model.decode_layout(cfg, rts[2], batch)
    caches = [split_model.init_decode_cache(params, cfg, lay, MAX_LEN,
                                            side=side) for _ in range(2)]
    serve = steps.make_serve_step(cfg, rts[0])
    decode_mesh, shards = split_model.decode_mesh, []

    def recorded(*a, **kw):
        out = decode_mesh(*a, **kw)
        shards.append(mesh_mod.pmap(lambda _, lg: lg.clone(), out[1]))
        return out

    tok = torch.from_numpy(_prompt(cfg, batch))
    toks = [tok]
    split_model.decode_mesh = recorded
    try:
        for _ in range(STEPS):
            tok, _ = serve(params, caches[0], tok)
            toks.append(tok)
    finally:
        split_model.decode_mesh = decode_mesh
    logits = [split_model.decode_step(params, cfg, rts[1], t, caches[1])[0]
              for t in toks[:REF_STEPS]]
    serve_bytes, decode_bytes = ({k: v / n for k, v in collective_bytes(
        reg.snapshot()).items()} for reg, n in zip(regs, (STEPS,
                                                          REF_STEPS)))
    built = {k: v / 2 for k, v in collective_bytes(
        regs[2].snapshot()).items()}
    return (torch.cat(toks[1:], 1), shards, logits, serve_bytes,
            decode_bytes, built, _nbytes(params))


def _nbytes(tree):
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _runs(weights, mesh):
    """Every config at B 4, and `WHOLE`'s at B 1, which the batch shards
    of (2, 2) and (2, 1, 2) do not divide: every shard holds the row."""
    out = {arch: _serve(arch, p, mesh) for arch, p in weights.items()}
    out.update({("whole", arch): _serve(arch, weights[arch], mesh, 1)
                for arch in WHOLE})
    return out


def _rank(rank, dev, shape, axes, weights):
    torch.set_num_threads(1)
    return _runs(weights, make_process_mesh(shape, axes, dev))


def _reference(arch):
    """The reference's weights (converted; the vlm's gates at 0.5) and
    its mesh-less logits for the first `REF_STEPS` tokens of the
    single controller's chain (computed by `run`)."""
    jcfg = jconfigs.get(arch, smoke=True).with_(split=JSplit(
        cut_layer=ARCHS[arch], compressor="randtopk", k=16))
    cfg = _cfg(arch)
    npp = jax.tree.map(np.asarray, jtr.init_model(jax.random.key(0), jcfg))
    if cfg.family == "vlm":
        npp = set_gates(npp, 0.5)
    return jcfg, jax.tree.map(jnp.asarray, npp), \
        params_from_jax(npp, cfg, "cpu")


def _jax_logits(arch, jcfg, jp, toks):
    """The JAX package's mesh-less decode step fed the prompt and then
    `toks`: the logits of its first `REF_STEPS` steps."""
    jrt = JRuntime(mesh=None, training=False)
    jex = None
    side = _side(_cfg(arch))
    if side is not None:
        jex = jtr.make_extras(jp, jcfg, jrt, {k: jnp.asarray(v)
                                              for k, v in side.items()})
    cache = jtr.init_cache(jp, jcfg, jrt, B, MAX_LEN, extras_batch=jex)
    decode = jax.jit(lambda p, c, t: jsplit_model.decode_step(
        p, jcfg, jrt, t, c))
    feed = np.concatenate([_prompt(_cfg(arch)), toks.numpy()], 1)
    out = []
    for i in range(REF_STEPS):
        lg, cache = decode(jp, cache, jnp.asarray(feed[:, i:i + 1],
                                                  dtype=jnp.int32))
        out.append(np.asarray(lg))
    return out


@pytest.fixture(scope="module")
def weights():
    return {arch: _reference(arch) for arch in ARCHS}


@pytest.fixture(scope="module", params=list(MESHES))
def run(request, weights, tmp_path_factory):
    shape, axes = MESHES[request.param]
    ranks = spawn(_rank, int(np.prod(shape)), (shape, axes, {
        a: w[2] for a, w in weights.items()}), device="cpu", timeout=JOIN_S,
        store_dir=tmp_path_factory.mktemp("store"))
    return {"shape": dict(zip(axes, shape)), "ranks": ranks,
            "single": _runs({a: w[2] for a, w in weights.items()},
                            make_mesh(shape, axes, devices="cpu"))}


_JAX = {}


KEYS = list(ARCHS) + [("whole", a) for a in WHOLE]
IDS = list(ARCHS) + [f"{a}-B1" for a in WHOLE]


def _batch_of(key):
    return (1, key[1]) if isinstance(key, tuple) else (B, key)


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_tokens_and_logits_equal_the_single_controller(run, key):
    batch, arch = _batch_of(key)
    toks, shards, logits = run["single"][key][:3]
    assert toks.shape == (batch, STEPS)
    for rank, got in enumerate(run["ranks"]):
        assert torch.equal(got[key][0], toks)
        assert len(got[key][1]) == STEPS
        for a, b in zip(got[key][1], shards):
            assert all(x is None for p, x in enumerate(a) if p != rank)
            assert torch.equal(a[rank], b[rank])
        for a, b in zip(got[key][2], logits):
            assert a.shape == b.shape == (batch, 1,
                                          _cfg(arch).padded_vocab)
            assert torch.equal(a, b)


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_counted_bytes_equal_decode_collective_costs(run, key):
    batch, arch = _batch_of(key)
    cfg = _cfg(arch)
    want = {argmax: analysis.decode_collective_costs(
        cfg, batch, MAX_LEN, run["shape"], flash_decode=True,
        argmax=argmax)[0] for argmax in (True, False)}
    built = analysis.decode_cache_collective_costs(cfg, batch,
                                                   run["shape"])[0]
    for got in [run["single"][key]] + [r[key] for r in run["ranks"]]:
        assert got[3] == want[True]
        assert got[4] == want[False]
        assert got[5] == built


@pytest.mark.parametrize("arch", list(ARCHS))
def test_first_steps_match_the_reference_decode_step(run, weights, arch):
    toks = run["single"][arch][0]
    key = (arch, toks[:, :REF_STEPS].numpy().tobytes())
    if key not in _JAX:
        jcfg, jp, _ = weights[arch]
        _JAX[key] = _jax_logits(arch, jcfg, jp, toks)
    atol = REF_ATOL.get(arch, 1e-4)
    for got in run["ranks"]:
        for lg, want in zip(got[arch][2], _JAX[key]):
            lg = lg.numpy()
            np.testing.assert_allclose(lg, want, rtol=0, atol=atol)
            np.testing.assert_array_equal(np.argmax(lg[:, -1], -1),
                                          np.argmax(want[:, -1], -1))


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_each_rank_decodes_on_its_use_blocks(run, weights, key):
    _, arch = _batch_of(key)
    cfg, params = _cfg(arch), weights[arch][2]
    mesh = make_mesh(tuple(run["shape"].values()), tuple(run["shape"]),
                     devices="meta")
    want = specs.block_bytes(params, specs.use_layouts(
        cfg, Runtime(training=False, mesh=mesh), "decode", params),
        mesh.shape)
    whole = _nbytes(params)
    assert want < whole
    assert run["single"][key][6] == whole
    for got in run["ranks"]:
        assert got[key][6] == want
