"""Port parity: the vision and audio families, llama-3.2-vision-90b (vlm:
gated cross-attention layers over image patches, one every
`cross_attn_every` layers) and whisper-tiny (audio: a bidirectional
encoder over frames, decoder layers with cross attention over its output,
layer norm everywhere), at SMOKE in f32 from the JAX reference's weights.

Every `gate` leaf is set to 0.5 in the numpy weights before either
package sees them: at their initial 0 every gated output is tanh(0) * y =
0, and a port that dropped the cross branch would still agree. Patches
and frames are N(0, 1) * 0.02 from a numpy seed, so the cross KV is not
zero either.

  * the registry: FULL and SMOKE field for field the reference's, and
    `tests/test_arch_smoke.py`'s assertions on FULL;
  * the converted tree keeps the reference's layout leaf for leaf;
  * the blocks alone: `layer_norm`, `sinusoidal_positions`,
    `cross_attention` (from tokens and from the cache, gated and not),
    `cross_kv` and the gated `mlp`;
  * `run_encoder` and `make_extras`;
  * the full forward and the split forward (randtopk at the cut, the
    reference's draws handed across as in `test_torch_training.py`), and
    the logits move when the gates go from 0 to 0.5;
  * one training step: loss, grad norm and every updated parameter, the
    gates, `enc_layers` and `enc_norm` among them;
  * `decode_layers` over [0, cut) and [cut, L) from caches built with
    the batch's extras, token by token; a vlm range that is not whole
    groups raises (the reference mis-slices it without a word);
  * `init_cache(bits=8)`: the self KV int8, `cross_kv` in the activation
    dtype, the reference's per-session shapes.

Tolerances: block outputs, activations, logits and KV within rtol 1e-5,
atol 1e-6 (`TOL`); positions exact; training within
`test_torch_training.py`'s tolerances. Serving parity is in
`test_torch_multimodal_serving.py`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.launch import steps as jlsteps
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import transformer as jtr
from repro.models.config import Runtime as JRuntime
from repro.models.config import SplitConfig as JSplit
from repro.optim import adamw_init as jadamw_init
from repro.runtime import steps as jsteps
from repro.split import model as jsplit_model
from test_torch_training import (_assert_params, _inject_reference_draws,
                                 _sorted)
from repro_torch import configs
from repro_torch.launch import steps as lsteps
from repro_torch.models import attention, common, mlp, transformer
from repro_torch.models.config import Runtime, SplitConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.adamw import adamw_init
from repro_torch.split import model as split_model

ARCHS = ["llama-3.2-vision-90b", "whisper-tiny"]
# vlm SMOKE: 4 layers in groups of 2 (a self layer, then a cross layer),
# so the cut at 2 leaves one cross site on each side; whisper SMOKE: 2
CUT = {"llama-3.2-vision-90b": 2, "whisper-tiny": 1}
TOL = dict(rtol=1e-5, atol=1e-6)
RT = JRuntime(mesh=None, training=False)
LR = 1e-3
ALPHA = 0.3
GATE = 0.5
B, S = 2, 16
FULL = {
    "llama-3.2-vision-90b": dict(n_layers=100, d_model=8192, n_heads=64,
                                 n_kv_heads=8, d_ff=28672, vocab=128256,
                                 cross_attn_every=5, n_image_tokens=1601),
    "whisper-tiny": dict(n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
                         d_ff=1536, vocab=51865, encdec=True,
                         n_enc_layers=4, n_frames=1500, norm="layer"),
}


def set_gates(tree, value=GATE):
    """The numpy tree with every `gate` leaf set to `value`."""
    return {k: set_gates(v, value) if isinstance(v, dict)
            else (np.full_like(v, value) if k == "gate" else v)
            for k, v in tree.items()}


def gated_weights(arch, value=GATE, seed=0):
    """(reference config, port config, reference params, port params),
    every gate at `value`."""
    jcfg = jconfigs.get(arch, smoke=True)
    cfg = configs.get(arch, smoke=True)
    npp = set_gates(jax.tree.map(np.asarray,
                                 jtr.init_model(jax.random.key(seed), jcfg)),
                    value)
    return (jcfg, cfg, jax.tree.map(jnp.asarray, npp),
            params_from_jax(npp, cfg, "cpu"))


def side_input(cfg, rows, seed=7):
    """(name, numpy array): the vlm's patches or whisper's frames,
    N(0, 1) * 0.02."""
    name, n = (("patches", cfg.n_image_tokens) if cfg.family == "vlm"
               else ("frames", cfg.n_frames))
    rng = np.random.RandomState(seed)
    return name, (rng.randn(rows, n, cfg.d_model) * 0.02).astype(np.float32)


def batches(cfg, step=0, rows=B, seq=S):
    """(reference batch, port batch): the same tokens, labels and side
    input."""
    rng = np.random.RandomState(100 + step)
    tokens = rng.randint(0, cfg.vocab, (rows, seq)).astype(np.int32)
    name, side = side_input(cfg, rows, seed=200 + step)
    nb = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1),
          name: side}
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


def _np(t):
    return t.detach().numpy()


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return (request.param,) + gated_weights(request.param)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_reference_configs(arch, smoke):
    cfg, jcfg = configs.get(arch, smoke=smoke), jconfigs.get(arch,
                                                             smoke=smoke)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    if not smoke:
        for key, val in FULL[arch].items():
            assert getattr(cfg, key) == val, key


def test_converted_params_keep_the_reference_layout(model):
    _, jcfg, cfg, jp, tp = model
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == len(jax.tree_util.tree_leaves(tp))
    for path, leaf in flat_j:
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    fresh = transformer.init_model(cfg, torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda t: tuple(t.shape), fresh) == \
        jax.tree.map(lambda t: tuple(t.shape), tp)
    gates = [k for k, _ in jax.tree_util.tree_flatten_with_path(jp)[0]
             if k[-1].key == "gate"]
    assert len(gates) == (2 if cfg.family == "vlm" else 0)


@pytest.mark.parametrize("shape", [(3, 128), (2, 5, 384)])
def test_layer_norm_matches_reference(shape):
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    scale, bias = rng.randn(2, shape[-1]).astype(np.float32)
    want = jcommon.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                              jnp.asarray(bias))
    got = common.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                            torch.from_numpy(bias))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    p = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
    assert torch.equal(common.apply_norm(torch.from_numpy(x), p, "layer"),
                       got)
    assert set(common.init_norm(8, torch.float32, kind="layer")) == \
        {"scale", "bias"}


@pytest.mark.parametrize("n_pos,d", [(16, 128), (1500, 384)])
def test_sinusoidal_positions_match_reference(n_pos, d):
    """Up to whisper's 1500 frames, where an angle's f32 ulp is 1.2e-4."""
    want = np.asarray(jcommon.sinusoidal_positions(n_pos, d))
    got = _np(common.sinusoidal_positions(n_pos, d))
    assert got.shape == want.shape == (n_pos, d)
    np.testing.assert_allclose(got, want, **TOL)


def _block(model, sub):
    """One cross block's weights in both packages: the vlm's first cross
    layer (`sub` "attn" or "mlp"), or whisper's first decoder layer's
    `cross`."""
    _, jcfg, cfg, jp, tp = model
    stack = "cross_layers" if cfg.family == "vlm" else "layers"
    jl = jax.tree.map(lambda a: a[0], jp[stack])[sub]
    return jl, transformer.layer_params(tp, 0, stack)[sub]


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
def test_cross_attention_and_cross_kv_match_reference(model, gated):
    _, jcfg, cfg, jp, tp = model
    sub = "attn" if cfg.family == "vlm" else "cross"
    jl, tl = _block(model, sub)
    if gated and "gate" not in tl:           # whisper's cross is ungated
        jl, tl = dict(jl, gate=jnp.float32(GATE)), dict(
            tl, gate=torch.tensor(GATE))
    rng = np.random.RandomState(1)
    x = rng.randn(B, 5, cfg.d_model).astype(np.float32)
    _, kv_tok = side_input(cfg, B)
    jk, jv = jattn.cross_kv(jl, jcfg, jnp.asarray(kv_tok))
    k, v = attention.cross_kv(tl, cfg, torch.from_numpy(kv_tok))
    np.testing.assert_allclose(_np(k), np.asarray(jk), **TOL)
    np.testing.assert_allclose(_np(v), np.asarray(jv), **TOL)
    assert float(np.abs(np.asarray(jk)).max()) > 0
    want = jattn.cross_attention(jl, jcfg, RT, jnp.asarray(x),
                                 jnp.asarray(kv_tok), gated=gated)
    got = attention.cross_attention(tl, cfg, torch.from_numpy(x),
                                    torch.from_numpy(kv_tok), gated=gated)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    cached = attention.cross_attention(tl, cfg, torch.from_numpy(x),
                                       kv_cache=(k, v), gated=gated)
    jcached = jattn.cross_attention(jl, jcfg, RT, jnp.asarray(x),
                                    kv_cache=(jk, jv), gated=gated)
    np.testing.assert_allclose(_np(cached), np.asarray(jcached), **TOL)
    np.testing.assert_allclose(_np(cached), _np(got), **TOL)
    if gated:
        ungated = attention.cross_attention(tl, cfg, torch.from_numpy(x),
                                            torch.from_numpy(kv_tok))
        np.testing.assert_allclose(_np(got), np.tanh(GATE) * _np(ungated),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
def test_mlp_matches_reference(gated):
    jcfg, cfg, jp, tp = gated_weights("llama-3.2-vision-90b")
    stack = "cross_layers" if gated else "layers"
    jl = jax.tree.map(lambda a: a[0], jp[stack])["mlp"]
    tl = transformer.layer_params(tp, 0, stack)["mlp"]
    x = np.random.RandomState(2).randn(B, 5, cfg.d_model).astype(np.float32)
    want = jmlp.mlp(jl, jcfg, RT, jnp.asarray(x), gated=gated)
    got = mlp.mlp(tl, torch.from_numpy(x), gated=gated)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_run_encoder_and_make_extras_match_reference(model):
    _, jcfg, cfg, jp, tp = model
    jb, tb = batches(cfg)
    jex = jtr.make_extras(jp, jcfg, RT, jb)
    with torch.no_grad():
        ex = transformer.make_extras(tp, cfg, Runtime(training=False), tb)
    assert sorted(ex) == sorted(jex) == (["patches"] if cfg.family == "vlm"
                                         else ["enc_out"])
    for name in ex:
        np.testing.assert_allclose(_np(ex[name]), np.asarray(jex[name]),
                                   **TOL)
    if cfg.family == "audio":
        with torch.no_grad():
            enc = transformer.run_encoder(tp, cfg, Runtime(training=False),
                                          tb["frames"])
        assert torch.equal(enc, ex["enc_out"])
        assert enc.shape == (B, cfg.n_frames, cfg.d_model)


def test_forward_and_split_forward_match_reference(model, monkeypatch):
    """The full forward, and the split forward with randtopk k 16 at the
    cut in training mode (the reference's draws handed across)."""
    arch, jcfg, cfg, jp, tp = model
    jb, tb = batches(cfg)
    jl, _ = jtr.forward(jp, jcfg, RT, jb)
    with torch.no_grad():
        logits, _ = transformer.forward(tp, cfg, Runtime(training=False), tb)
    np.testing.assert_allclose(_np(logits), np.asarray(jl), **TOL)

    split = dict(cut_layer=CUT[arch], compressor="randtopk", k=16,
                 alpha=ALPHA)
    key = jax.random.key(5)
    _inject_reference_draws(monkeypatch, key, ALPHA, 16, (B, S, cfg.d_model))
    jsl, jsa = jsplit_model.forward(
        jp, jcfg.with_(split=JSplit(**split)), JRuntime(training=True), jb,
        key=key)
    with torch.no_grad():
        sl, sa = split_model.forward(tp, cfg.with_(split=SplitConfig(
            **split)), Runtime(training=True), tb,
            generator=torch.Generator())
    np.testing.assert_allclose(_np(sl), np.asarray(jsl), **TOL)
    np.testing.assert_allclose(float(sa), float(jsa), **TOL)


def test_split_forward_runs_the_encoder_once(model, monkeypatch):
    """Both halves of a split forward read one encoder output (the vlm
    has no encoder)."""
    arch, jcfg, cfg, jp, tp = model
    calls = []
    run = transformer.run_encoder
    monkeypatch.setattr(transformer, "run_encoder",
                        lambda *a: calls.append(1) or run(*a))
    _, tb = batches(cfg)
    with torch.no_grad():
        split_model.forward(tp, cfg.with_(split=SplitConfig(
            cut_layer=CUT[arch], compressor="topk", k=16)),
            Runtime(training=False), tb)
    assert len(calls) == (1 if cfg.family == "audio" else 0)


def test_cross_branch_changes_the_logits(model):
    """The same weights with the gates at 0 (the vlm) or with zero frames
    (whisper, whose cross attention has no gate) give other logits: the
    cross branch is live."""
    arch, jcfg, cfg, jp, tp = model
    _, tb = batches(cfg)
    rt = Runtime(training=False)
    with torch.no_grad():
        live, _ = transformer.forward(tp, cfg, rt, tb)
        if cfg.family == "vlm":
            shut = transformer.forward(gated_weights(arch, 0.0)[3], cfg, rt,
                                       tb)[0]
        else:
            shut = transformer.forward(tp, cfg, rt, dict(
                tb, frames=torch.zeros_like(tb["frames"])))[0]
    assert float((live - shut).abs().max()) > 1e-3


def test_train_step_matches_reference(model, monkeypatch):
    """One AdamW step, randtopk k 16 at the cut: loss, grad norm and every
    updated parameter (the gates, the encoder and its norm included)."""
    arch, jcfg, cfg, jp, tp = model
    split = dict(cut_layer=CUT[arch], compressor="randtopk", k=16,
                 alpha=ALPHA)
    jcfg, cfg = jcfg.with_(split=JSplit(**split)), cfg.with_(
        split=SplitConfig(**split))
    jstep = jax.jit(jlsteps.make_train_step(jcfg, JRuntime(training=True),
                                            lr=LR))
    step = lsteps.make_train_step(cfg, Runtime(training=True), lr=LR)
    jb, tb = batches(cfg)
    key = jax.random.key(11)
    _inject_reference_draws(monkeypatch, key, ALPHA, 16, (B, S, cfg.d_model))
    jp2, _, jm = jstep(jp, jadamw_init(jp), jb, key)
    tp2, _, m = step(tp, adamw_init(tp), tb, torch.Generator())
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    _assert_params(_sorted(jp2), _sorted(tp2), 1)
    moved = ["cross_layers"] if cfg.family == "vlm" else ["enc_layers",
                                                          "enc_norm"]
    for name in moved:
        for a, b in zip(jax.tree_util.tree_leaves(tp[name]),
                        jax.tree_util.tree_leaves(tp2[name])):
            assert not torch.equal(a, b), name
    if cfg.family == "vlm":
        for sub in ("attn", "mlp"):
            np.testing.assert_allclose(
                _np(tp2["cross_layers"][sub]["gate"]),
                np.asarray(jp2["cross_layers"][sub]["gate"]), **TOL)


def _cross_view(jckv):
    """The reference's batched cross KV (sites, 2, B, N, Hkv, hd) in the
    port's rows-first layout (B, sites, 2, 1, N, Hkv, hd)."""
    return np.asarray(jckv).transpose(2, 0, 1, 3, 4, 5)[:, :, :, None]


def _n_self(cfg, cut):
    """Entries of `cache["kv"]` below the cut: the vlm's self layers."""
    return cut - cut // cfg.cross_attn_every if cfg.family == "vlm" else cut


def test_decode_layers_match_reference(model):
    """Two sessions from caches built with their patches or encoder
    output, five tokens through [0, cut) then [cut, L): the cut
    activation, the logits, the KV of both ranges and the cross KV."""
    arch, jcfg, cfg, jp, tp = model
    cut, L, max_len = CUT[arch], cfg.n_layers, 6
    jb, tb = batches(cfg)
    jex = jtr.make_extras(jp, jcfg, RT, jb)
    with torch.no_grad():
        ex = transformer.make_extras(tp, cfg, Runtime(training=False), tb)
    jcache = jtr.init_cache(jp, jcfg, RT, B, max_len, extras_batch=jex)
    cache = transformer.init_cache(cfg, B, max_len, params=tp, extras=ex)
    np.testing.assert_allclose(_np(cache["cross_kv"]),
                               _cross_view(jcache["cross_kv"]), **TOL)
    assert float(cache["cross_kv"].abs().max()) > 0
    ckv0 = cache["cross_kv"].clone()
    jbottom = jax.jit(lambda p, x, c: jtr.decode_layers(p, jcfg, RT, x, c, 0,
                                                        cut))
    jtop = jax.jit(lambda p, x, c: jtr.decode_layers(p, jcfg, RT, x, c, cut,
                                                     L))
    rng = np.random.RandomState(4)
    for _ in range(5):
        tok = rng.randint(0, cfg.vocab, (B, 1)).astype(np.int32)
        jx = jtr.embed(jp, jcfg, RT, jnp.asarray(tok))
        jx1, nc1 = jbottom(jp, jx, jcache)
        jx2, nc2 = jtop(jp, jx1, jcache)
        jl = jtr.lm_head(jp, jcfg, RT, jx2)
        jcache = jsteps._merge_range(jsteps._merge_range(
            jcache, nc1, prefix=True), nc2, prefix=False)
        jcache["pos"] = jcache["pos"] - 1       # one token, one advance
        with torch.no_grad():
            x = transformer.embed(tp, cfg, torch.from_numpy(tok))
            x1 = transformer.decode_layers(tp, cfg, x, cache, 0, cut)
            x2 = transformer.decode_layers(tp, cfg, x1, cache, cut, L)
            logits = transformer.lm_head(tp, cfg, x2)
        cache["pos"] += 1
        np.testing.assert_allclose(_np(x1), np.asarray(jx1), **TOL)
        np.testing.assert_allclose(_np(logits), np.asarray(jl), **TOL)
    assert int(jcache["pos"]) == 5
    np.testing.assert_array_equal(cache["pos"].numpy(), [5, 5])
    for leaf in ("k", "v"):
        # reference (n, B, size, Hkv, hd); the port (B, n, 1, size, ...)
        want = np.asarray(jcache["kv"][leaf]).swapaxes(0, 1)[:, :, None]
        np.testing.assert_allclose(_np(cache["kv"][leaf]), want, **TOL)
        assert want.shape[1] == _n_self(cfg, L)
    assert torch.equal(cache["cross_kv"], ckv0)


def test_vlm_range_not_whole_groups_raises():
    jcfg, cfg, jp, tp = gated_weights("llama-3.2-vision-90b")
    g = cfg.cross_attn_every
    cache = transformer.init_cache(cfg, 1, 4, params=tp)
    x = torch.zeros((1, 1, cfg.d_model))
    _, tb = batches(cfg)
    ex = {"patches": tb["patches"]}
    for lo, hi in ((0, 1), (1, cfg.n_layers), (1, g + 1)):
        with pytest.raises(ValueError, match="whole groups"):
            transformer.decode_layers(tp, cfg, x, cache, lo, hi)
        with pytest.raises(ValueError, match="whole groups"):
            transformer.apply_layers(tp, cfg, Runtime(training=False),
                                     torch.zeros((B, S, cfg.d_model)), ex,
                                     lo, hi)
    with pytest.raises(ValueError, match="multiple of cross_attn_every"):
        transformer.init_model(cfg.with_(n_layers=3), torch.Generator())


def test_init_cache_needs_the_weights():
    cfg = configs.get("whisper-tiny", smoke=True)
    with pytest.raises(ValueError, match="needs the weights"):
        transformer.init_cache(cfg, 1, 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_cache_layout(arch):
    """bits=8 quantizes the self KV only; `cross_kv` stays in the
    activation dtype, as in the reference. Per-session shapes and dtypes
    are the reference's."""
    jcfg, cfg, jp, tp = gated_weights(arch)
    cache = transformer.init_cache(cfg, 3, 8, bits=8, params=tp)
    jcache = jtr.init_cache(jp, jcfg, JRuntime(mesh=None, training=False,
                                               kv_cache_bits=8), 1, 8)
    assert sorted(cache) == sorted(jcache)
    assert cache["kv"]["k"].dtype == torch.int8
    assert cache["cross_kv"].dtype == cfg.adtype() == torch.float32
    assert sorted(cache["kv"]) == sorted(jcache["kv"])
    for name, leaf in list(jcache["kv"].items()) + [
            ("cross_kv", jcache["cross_kv"])]:
        got = cache["cross_kv"] if name == "cross_kv" else cache["kv"][name]
        assert tuple(got.shape[1:]) == leaf.shape, name
        assert str(got.dtype).split(".")[-1] == str(leaf.dtype), name
