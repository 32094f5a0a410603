"""The whole-batch serve step of the hybrid, ssm, vlm and audio families
on a decode mesh (`Runtime.mesh`, `tp.Layout(decode=True)`), on the CPU,
every position `devices="cpu"`, one torch thread, SMOKE in f32, split
randtopk k 16 (TopK at inference): zamba2-7b (cut 2: one
shared-attention site on each side), rwkv6-1.6b (cut 1),
llama-3.2-vision-90b (cut 2, whole groups; every gate at 0.5, the
caches of the rows' patches) and whisper-tiny (cut 1, the caches of the
rows' encoder output), against the port's own `mesh=None` step.

  * (1, 1) equals mesh=None bit for bit: logits, tokens, every cache
    leaf.
  * At (1, 4), (2, 2), (4, 1) and (2, 2, 2), flash decode on and off:
    the logits of `split.model.decode_step` within 2e-5 of mesh=None's
    over a 12-slot ring that 14 steps wrap (rwkv6 too: the largest
    difference measured over these meshes is 6.9e-6, zamba2's 1.6e-6),
    and the tokens of
    `launch.steps.make_serve_step` equal. SMOKE splits every Mamba2 (16)
    and RWKV6 (4) head count over 'model' 4, the vlm's 8 patches and
    whisper's 16 frames too, but whisper's 2 heads stay whole at 4.
  * Counted collective bytes (`mesh.collective_bytes`) of every step
    equal `roofline.analysis.decode_collective_costs`, with and without
    the serve step's argmax; the cache's own (whisper's encoder output
    over the pod ring) `decode_cache_collective_costs`; by hand for each
    family.
  * A vlm whose 'model' does not divide its patches keeps its cross KV
    whole (as llama-3.2-vision-90b's 1601 on 'model' 4); zamba2's sites
    on the int8 KV cache; B 1 stays whole on a 'data' axis of 2; on the
    pod ring every position's top-layer cross KV is mesh=None's for the
    rows it holds.
  * At (2, 2) the first 3 steps against the JAX reference's mesh-less
    `repro.split.model.decode_step` from the reference's weights
    (`models.convert.params_from_jax`) and the inputs of
    `tests/test_torch_serve_step.py`: logits within 1e-4 (rwkv6 1e-3,
    the f32 conditioning both packages share, ROADMAP Queue 3), tokens
    equal.
"""
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
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.mesh import collective_bytes
from repro_torch.models import transformer
from repro_torch.models.config import Runtime, SplitConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.roofline import analysis
from repro_torch.split import model as split_model
from repro_torch.split import protocol

# (arch, cut)
ARCHS = {"zamba2-7b": 2, "rwkv6-1.6b": 1, "llama-3.2-vision-90b": 2,
         "whisper-tiny": 1}
MESHES = [("1x4", (1, 4)), ("2x2", (2, 2)), ("4x1", (4, 1)),
          ("2x2x2", (2, 2, 2))]
B, MAX_LEN, STEPS = 4, 12, 14
ATOL = 2e-5
REF_STEPS, REF_ATOL = 3, {"rwkv6-1.6b": 1e-3}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape):
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return make_mesh(shape, axes, devices="cpu")


def _cfg(arch, **kw):
    return configs.get(arch, smoke=True).with_(split=SplitConfig(
        cut_layer=ARCHS[arch], compressor="randtopk", k=16), **kw)


_PARAMS = {}


def _params(cfg):
    """Random weights from a seed; the vlm's gates at 0.5, so its cross
    branch reaches the logits."""
    key = (cfg.name, cfg.n_layers)
    if key not in _PARAMS:
        params = transformer.init_model(
            cfg, torch.Generator().manual_seed(0), device="cpu")
        if cfg.family == "vlm":
            for sub in ("attn", "mlp"):
                params["cross_layers"][sub]["gate"].fill_(0.5)
        _PARAMS[key] = params
    return _PARAMS[key]


def _side(cfg, batch=B):
    """The rows' side inputs: the vlm's patches, whisper's frames (the
    draws of `tests/test_torch_serve_step.py`); none otherwise."""
    if cfg.family not in ("vlm", "audio"):
        return None
    name, n = (("patches", cfg.n_image_tokens) if cfg.family == "vlm"
               else ("frames", cfg.n_frames))
    return {name: torch.from_numpy((np.random.RandomState(7).randn(
        batch, n, cfg.d_model) * 0.02).astype(np.float32))}


def _prompts(batch, vocab):
    return torch.from_numpy(np.random.RandomState(5).randint(
        0, vocab, (batch, 1)).astype(np.int64))


def _rt(mesh=None, registry=None, **kw):
    return Runtime(training=False, mesh=mesh, registry=registry, **kw)


def _cache(cfg, rt, batch, bits, side):
    params = _params(cfg)
    if rt.mesh is None:
        extras = None
        if side is not None:
            with torch.no_grad():
                extras = transformer.make_extras(params, cfg, rt, side)
        return transformer.init_cache(cfg, batch, MAX_LEN, bits=bits,
                                      params=params, extras=extras)
    return split_model.init_decode_cache(
        params, cfg, split_model.decode_layout(cfg, rt, batch), MAX_LEN,
        bits, side=side)


def _run(cfg, mesh=None, batch=B, bits=16, **rt_kw):
    """Two chains of `STEPS` tokens from one prompt token a row: the
    serve step's greedy tokens, and `split.model.decode_step` fed those
    tokens, each with its own cache and registry. Returns (logits a
    step, tokens a step, the decode chain's cache, the serve chain's
    counted bytes a step, the decode chain's, the counted bytes of
    building one cache)."""
    params, side = _params(cfg), _side(cfg, batch)
    regs = (MetricsRegistry(), MetricsRegistry(), MetricsRegistry())
    caches = [_cache(cfg, _rt(mesh, regs[2], **rt_kw), batch, bits, side)
              for _ in range(2)]
    rts = [_rt(mesh, reg, **rt_kw) for reg in regs[:2]]
    serve = steps.make_serve_step(cfg, rts[0])
    tok = _prompts(batch, cfg.vocab)
    logits, toks = [], []
    for _ in range(STEPS):
        lg, _ = split_model.decode_step(params, cfg, rts[1], tok, caches[1])
        tok, _ = serve(params, caches[0], tok)
        logits.append(lg)
        toks.append(tok)
    counted = [{k: v / STEPS for k, v in collective_bytes(
        reg.snapshot()).items()} for reg in regs[:2]]
    built = {k: v / 2 for k, v in collective_bytes(
        regs[2].snapshot()).items()}
    return logits, torch.cat(toks, 1), caches[1], counted[0], counted[1], \
        built


_REF = {}


def _reference(cfg, **kw):
    key = (cfg, tuple(sorted(kw.items())))
    if key not in _REF:
        _REF[key] = _run(cfg, **kw)
    return _REF[key]


def _assert_matches(cfg, shape, flash, dp_only=False, **kw):
    mesh = _mesh(shape)
    ref_logits, ref_toks = _reference(cfg, **kw)[:2]
    logits, toks, caches, serve_bytes, decode_bytes, built = _run(
        cfg, mesh, flash_decode=flash, dp_only=dp_only, **kw)
    torch.testing.assert_close(toks, ref_toks, rtol=0, atol=0)
    for got, want in zip(logits, ref_logits):
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    batch = kw.get("batch", B)
    for counted, argmax in ((serve_bytes, True), (decode_bytes, False)):
        want, _ = analysis.decode_collective_costs(
            cfg, batch, MAX_LEN, mesh.shape, flash_decode=flash,
            dp_only=dp_only, argmax=argmax)
        assert counted == want, (argmax, counted, want)
    want, _ = analysis.decode_cache_collective_costs(cfg, batch, mesh.shape,
                                                     dp_only=dp_only)
    assert built == want, (built, want)
    return caches, serve_bytes


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch", list(ARCHS))
def test_one_by_one_mesh_is_mesh_none_bit_for_bit(arch):
    cfg = _cfg(arch)
    ref_logits, ref_toks, ref_cache = _reference(cfg)[:3]
    logits, toks, caches, serve_bytes, decode_bytes, built = _run(
        cfg, _mesh((1, 1)))
    assert torch.equal(toks, ref_toks)
    for got, want in zip(logits, ref_logits):
        assert torch.equal(got, want)
    (cache,) = caches
    got, want = _leaves(cache), _leaves(ref_cache)
    assert got.keys() == want.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name
    assert serve_bytes == decode_bytes == built == {}


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "replicated"])
@pytest.mark.parametrize("label,shape", MESHES, ids=[m[0] for m in MESHES])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_mesh_matches_mesh_none(arch, label, shape, flash):
    _assert_matches(_cfg(arch), shape, flash)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_state_heads_and_cross_tokens_split(arch):
    """At (1, 4) with flash decode each position holds a quarter of the
    Mamba2 (16) or RWKV6 (4) state heads and of the vlm's 8 patches or
    whisper's 16 frames; the conv history its heads' x columns and the
    b and c columns whole; the token shifts whole."""
    cfg = _cfg(arch)
    lay = split_model.decode_layout(cfg, _rt(_mesh((1, 4))), B)
    caches = split_model.init_decode_cache(_params(cfg), cfg, lay, MAX_LEN,
                                           side=_side(cfg))
    for c in caches:
        if cfg.family == "hybrid":
            H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
            assert c["mamba"]["h"].shape == (B, cfg.n_layers, H // 4, P, N)
            assert c["mamba"]["conv"].shape == (
                B, cfg.n_layers, cfg.ssm_conv - 1, H // 4 * P + 2 * N)
        elif cfg.family == "ssm":
            H = cfg.d_model // 64
            assert c["rwkv"]["S"].shape == (B, cfg.n_layers, H // 4, 64, 64)
            assert c["rwkv"]["x_tm"].shape == (B, cfg.n_layers, cfg.d_model)
            assert "kv" not in c
        else:
            N = transformer.cross_tokens(cfg)
            assert c["cross_kv"].shape[4] == N // 4


def test_vlm_patches_model_does_not_divide_stay_whole():
    """7 patches on 'model' 4 (llama-3.2-vision-90b's 1601 at full width):
    every position holds the whole cross KV, flash decode or not, and the
    cross layers attend their q heads over it, counting no partials."""
    cfg = _cfg("llama-3.2-vision-90b", n_image_tokens=7)
    rt = _rt(_mesh((1, 4)))
    lay = split_model.decode_layout(cfg, rt, B)
    assert lay.flash and not lay.ring_split(7) and lay.ring_split(MAX_LEN)
    caches = split_model.init_decode_cache(_params(cfg), cfg, lay, MAX_LEN,
                                           side=_side(cfg))
    assert {c["cross_kv"].shape[4] for c in caches} == {7}
    _, counted = _assert_matches(cfg, (1, 4), True)
    want = analysis.decode_collective_costs(_cfg("llama-3.2-vision-90b"), B,
                                            MAX_LEN, {"data": 1, "model": 4})
    n_cross, hq = cfg.n_layers // cfg.cross_attn_every, cfg.n_heads
    assert want[0]["all-reduce"] - counted["all-reduce"] == \
        n_cross * B * hq * (2 + cfg.hd) * 4


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "replicated"])
@pytest.mark.parametrize("shape", [(1, 4), (2, 2, 2)], ids=["1x4", "2x2x2"])
def test_zamba2_int8_kv_sites(shape, flash):
    _assert_matches(_cfg("zamba2-7b"), shape, flash, bits=8)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_batch_of_one_stays_whole(arch):
    """B 1 on a 'data' axis of 2 does not split: both batch shards hold
    the row (the reference's `_sanitize_spec` drops the axis)."""
    cfg = _cfg(arch)
    lay = split_model.decode_layout(cfg, _rt(_mesh((2, 2))), 1)
    assert lay.whole and lay.b_loc == 1 and len(lay.groups) == 2
    _assert_matches(cfg, (2, 2), True, batch=1)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_dp_only(arch):
    _assert_matches(_cfg(arch), (2, 2, 2), True, dp_only=True)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "whisper-tiny"])
def test_pod_ring_top_cross_kv_is_the_arriving_rows(arch):
    """At (2, 2, 2) the cut hands pod 0's rows to pod 1: every position's
    cross KV above the cut is mesh=None's of the rows it then holds (its
    share of the tokens), below the cut that of its own rows; the rows
    differ between the pods, so the other rows' would not pass."""
    cfg = _cfg(arch)
    mesh = _mesh((2, 2, 2))
    lay = split_model.decode_layout(cfg, _rt(mesh), B)
    caches = split_model.init_decode_cache(_params(cfg), cfg, lay, MAX_LEN,
                                           side=_side(cfg))
    ref = _cache(cfg, _rt(), B, 16, _side(cfg))["cross_kv"]
    origin = protocol.cut_origin(cfg, lay)
    assert origin != list(range(len(origin)))
    below = transformer._sites_below_cut(cfg)
    assert 0 < below < ref.shape[1]
    n = transformer.cross_tokens(cfg) // 2
    for p, c in enumerate(caches):
        b = lay.shard_of[p]
        part = slice(lay.rank(p) * n, (lay.rank(p) + 1) * n)
        own = ref[b * lay.b_loc:(b + 1) * lay.b_loc, :, :, :, part]
        top = ref[origin[b] * lay.b_loc:(origin[b] + 1) * lay.b_loc, :, :,
                  :, part]
        torch.testing.assert_close(c["cross_kv"][:, :below],
                                   own[:, :below], rtol=0, atol=1e-6)
        torch.testing.assert_close(c["cross_kv"][:, below:],
                                   top[:, below:], rtol=0, atol=1e-6)
        assert not torch.allclose(own[:, below:], top[:, below:])


def test_decode_collective_costs_by_hand():
    """SMOKE at (1, 4), B 4, f32, a 12-slot ring (3 slots a position):
    per flash-decoded KV the three all-reduces 4 x Hq x (1 + 1 + 64) x 4
    B, per split projection 4 x d x 4 B, and the argmax's two 4 x 4 B;
    the cut at (2, 2, 2) adds the payload's and the tokens'
    collective-permutes, and whisper's cache its encoder output's."""
    mesh = {"data": 1, "model": 4}
    argmax = 2 * 4 * 4

    def costs(arch, shape=mesh, **kw):
        return analysis.decode_collective_costs(_cfg(arch), B, MAX_LEN,
                                                shape, **kw)[0]

    def flash(hq):
        return 4 * hq * 66 * 4
    # zamba2 (d 256, 16 Mamba2 heads, 4 layers, 2 sites of 4 heads):
    # every layer's norm (4 x 4 B) and w_out, each site's attention
    # (partials, wo) and MLP
    proj = 4 * 256 * 4
    assert costs("zamba2-7b") == {"all-reduce": float(
        4 * (4 * 4 + proj) + 2 * (flash(4) + 2 * proj) + argmax)}
    # rwkv6 (d 256: 4 WKV heads, d_ff 512, 2 layers): both mixes split
    assert costs("rwkv6-1.6b") == {"all-reduce": float(
        2 * 2 * proj + argmax)}
    # the vlm (4 layers: 2 self, 2 cross over 8 patches; 4 q heads)
    assert costs("llama-3.2-vision-90b") == {"all-reduce": float(
        2 * (flash(4) + proj) + 2 * (flash(4) + proj) + 4 * proj + argmax)}
    # whisper (d 128, 2 heads stay whole at 4, d_ff 256, 2 layers; ring
    # and 16 frames flash-decoded)
    wproj = 4 * 128 * 4
    assert costs("whisper-tiny") == {"all-reduce": float(
        2 * (flash(2) + flash(2) + wproj) + argmax)}
    assert costs("whisper-tiny", flash_decode=False, argmax=False) == {
        "all-reduce": float(2 * wproj)}
    pod = {"pod": 2, "data": 2, "model": 2}
    cfg = _cfg("whisper-tiny")
    leaf = protocol.pod_leaf_sizes(cfg)[0]
    assert costs("whisper-tiny", pod)["collective-permute"] == 1 * leaf + 4
    assert analysis.decode_cache_collective_costs(cfg, B, pod)[0] == {
        "collective-permute": float(1 * 16 * 128 * 4)}
    assert analysis.decode_cache_collective_costs(
        _cfg("llama-3.2-vision-90b"), B, pod)[0] == {}


# ---------------------------------------------------------------------------
# against the JAX reference's mesh-less decode step
# ---------------------------------------------------------------------------

def _reference_weights(arch):
    jcfg = jconfigs.get(arch, smoke=True).with_(split=JSplit(
        cut_layer=ARCHS[arch], compressor="randtopk", k=16))
    cfg = _cfg(arch)
    npp = jax.tree.map(np.asarray, jtr.init_model(jax.random.key(0), jcfg))
    if cfg.family == "vlm":
        npp = set_gates(npp, 0.5)
    return jcfg, cfg, jax.tree.map(jnp.asarray, npp), \
        params_from_jax(npp, cfg, "cpu")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_two_by_two_matches_reference_decode_step(arch):
    jcfg, cfg, jp, tp = _reference_weights(arch)
    jrt = JRuntime(mesh=None, training=False)
    side = _side(cfg)
    jex = None
    if side is not None:
        (name, x), = side.items()
        jex = jtr.make_extras(jp, jcfg, jrt, {name: jnp.asarray(x.numpy())})
    jcache = jtr.init_cache(jp, jcfg, jrt, B, MAX_LEN, extras_batch=jex)
    jdecode = jax.jit(lambda p, c, t: jsplit_model.decode_step(
        p, jcfg, jrt, t, c))
    rt = _rt(_mesh((2, 2)))
    cache = split_model.init_decode_cache(
        tp, cfg, split_model.decode_layout(cfg, rt, B), MAX_LEN, side=side)
    prompts = np.random.RandomState(3).randint(
        0, cfg.vocab, (B, REF_STEPS)).astype(np.int32)
    atol = REF_ATOL.get(arch, 1e-4)
    for i in range(REF_STEPS):
        tok = prompts[:, i:i + 1]
        jl, jcache = jdecode(jp, jcache, jnp.asarray(tok))
        logits, out = split_model.decode_step(tp, cfg, rt,
                                              torch.from_numpy(tok), cache)
        assert out is cache
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=0,
                                   atol=atol)
        np.testing.assert_array_equal(
            torch.argmax(logits[:, -1], -1).numpy(),
            np.argmax(np.asarray(jl)[:, -1], -1))
