"""Port parity: the qk-norm dense and mixture-of-experts configurations
(qwen3-8b, granite-3-8b, phi3-mini-3.8b, granite-moe-1b-a400m,
qwen3-moe-235b-a22b) at SMOKE in f32, from the JAX reference's weights.

  * the registry: FULL and SMOKE field for field the reference's;
  * the converted tree keeps the reference's layout leaf for leaf;
  * the full forward and the split forward (topk at the cut): logits and
    the balance loss;
  * one training step (randtopk at the cut, the reference's draws handed
    across as in `test_torch_training.py`): loss, aux, grad norm and the
    updated parameters;
  * the client's bottom step and the server's arena top step over three
    slots with a changing active set (as `test_torch_model.py` does for
    yi-6b); for the moe configs, a live row's logits do not depend on what
    the other arena rows hold;
  * `run_streaming` at qwen3-8b and granite-moe-1b-a400m, and the serving
    and training CLIs on a moe config.

Activations, logits, KV and aux within rtol 1e-5, atol 1e-6; positions
and tokens exact; training within `test_torch_training.py`'s tolerances.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.core import compressors as JC
from repro.launch import steps as jlsteps
from repro.models import transformer as jtr
from repro.models.config import Runtime as JRuntime
from repro.models.config import SplitConfig as JSplit
from repro.optim import adamw_init as jadamw_init
from repro.runtime import steps as jsteps
from repro.split import model as jsplit_model
from test_torch_serving_parity import assert_serving_matches_reference, weights
from test_torch_training import (_assert_params, _batch,
                                 _inject_reference_draws, _sorted)
from repro_torch import configs
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import steps as lsteps
from repro_torch.launch import train as train_cli
from repro_torch.models import moe, transformer
from repro_torch.models.config import Runtime, SplitConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime import steps
from repro_torch.split import model as split_model

ARCHS = ["qwen3-8b", "granite-3-8b", "phi3-mini-3.8b",
         "granite-moe-1b-a400m", "qwen3-moe-235b-a22b"]
MOE = ["granite-moe-1b-a400m", "qwen3-moe-235b-a22b"]
CUT = 1
TOL = dict(rtol=1e-5, atol=1e-6)
RT = JRuntime(mesh=None, training=False)
LR = 1e-3
# tests/test_arch_smoke.py's assertions on the reference's FULL configs
FULL = {
    "qwen3-8b": dict(n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
                     d_ff=12288, vocab=151936, qk_norm=True),
    "granite-3-8b": dict(n_layers=40, d_model=4096, n_heads=32,
                         n_kv_heads=8, d_ff=12800, vocab=49155),
    "phi3-mini-3.8b": dict(n_layers=32, d_model=3072, n_heads=32,
                           n_kv_heads=32, d_ff=8192, vocab=32064),
    "granite-moe-1b-a400m": dict(n_layers=24, d_model=1024, n_heads=16,
                                 n_kv_heads=8, d_ff=512, vocab=49155,
                                 n_experts=32, topk_experts=8),
    "qwen3-moe-235b-a22b": dict(n_layers=94, d_model=4096, n_heads=64,
                                n_kv_heads=4, d_ff=1536, vocab=151936,
                                n_experts=128, topk_experts=8),
}


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg = jconfigs.get(arch, smoke=True)
    cfg = configs.get(arch, smoke=True)
    jp = jtr.init_model(jax.random.key(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return arch, jcfg, cfg, jp, tp


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


def test_forward_and_split_forward_match_reference(model):
    _, jcfg, cfg, jp, tp = model
    jb, tb = _batch(cfg, 0)
    jl, ja = jtr.forward(jp, jcfg, RT, jb)
    with torch.no_grad():
        logits, aux = transformer.forward(tp, cfg, Runtime(training=False),
                                          tb)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(aux), float(ja), **TOL)
    assert (float(aux) > 0) == (cfg.family == "moe")

    split = dict(cut_layer=CUT, compressor="topk", k=16)
    jsl, jsa = jsplit_model.forward(
        jp, jcfg.with_(split=JSplit(**split)), RT, jb, key=jax.random.key(1))
    with torch.no_grad():
        sl, sa = split_model.forward(tp, cfg.with_(split=SplitConfig(
            **split)), Runtime(training=False), tb)
    np.testing.assert_allclose(sl.numpy(), np.asarray(jsl), **TOL)
    np.testing.assert_allclose(float(sa), float(jsa), **TOL)


def test_train_step_matches_reference(model, monkeypatch):
    """One AdamW step, randtopk k 16 at the cut: loss (the balance loss
    weighted in), aux, grad norm and every updated parameter."""
    _, jcfg, cfg, jp, tp = model
    split = dict(cut_layer=CUT, compressor="randtopk", k=16, alpha=0.3)
    jcfg, cfg = jcfg.with_(split=JSplit(**split)), cfg.with_(
        split=SplitConfig(**split))
    jstep = jax.jit(jlsteps.make_train_step(jcfg, JRuntime(training=True),
                                            lr=LR))
    step = lsteps.make_train_step(cfg, Runtime(training=True), lr=LR)
    jb, tb = _batch(cfg, 0)
    key = jax.random.key(11)
    _inject_reference_draws(monkeypatch, key, 0.3, 16, (2, 16, cfg.d_model))
    jp2, _, jm = jstep(jp, jadamw_init(jp), jb, key)
    tp2, _, m = step(tp, adamw_init(tp), tb, torch.Generator())
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]), **TOL)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    assert float(m["loss"]) == pytest.approx(
        float(m["ce"]) + lsteps.AUX_WEIGHT * float(m["aux"]), rel=1e-6)
    assert lsteps.AUX_WEIGHT == jlsteps.AUX_WEIGHT
    _assert_params(_sorted(jp2), _sorted(tp2), 1)


def test_bottom_step_matches_reference(model):
    """Seven tokens through a ring of five cache slots, so the ring wraps."""
    _, jcfg, cfg, jp, tp = model
    max_len, toks = 5, [3, 17, 400, 9, 9, 250, 1]
    bottom = jax.jit(jsteps.make_bottom_step(jcfg, RT, CUT, JC.Compressor()))
    jcache = jtr.init_cache(jp, jcfg, RT, 1, max_len)
    cache = transformer.init_cache(cfg, 1, max_len)
    for t in toks:
        tok = np.asarray([[t]], np.int32)
        payload, jcache = bottom(jp, jcache, jnp.asarray(tok))
        x = steps.bottom_hidden(tp, cfg, CUT, cache, tok)
        np.testing.assert_allclose(x.numpy(), np.asarray(payload.values),
                                   **TOL)
    assert int(cache["pos"][0]) == int(jcache["pos"]) == len(toks)
    for leaf in ("k", "v"):
        want = np.asarray(jcache["kv"][leaf])
        got = cache["kv"][leaf][0].numpy()
        np.testing.assert_allclose(got[:CUT], want[:CUT], **TOL)
        np.testing.assert_array_equal(got[CUT:], 0.0)


def _jax_top(jcfg):
    def one(params, x, cache):
        x, partial = jtr.decode_layers(params, jcfg, RT, x, cache, CUT,
                                       jcfg.n_layers)
        logits = jtr.lm_head(params, jcfg, RT, x)
        return logits, jsteps._merge_range(cache, partial, prefix=False)
    return jax.jit(one)


def test_arena_top_step_matches_reference(model):
    """Three slots, each with its own position, and a changing active set:
    active rows' logits and tokens, the server's KV and every slot's
    position; inactive slots keep both."""
    _, jcfg, cfg, jp, tp = model
    C, max_len, d = 3, 6, cfg.d_model
    schedule = [[1, 1, 1], [1, 0, 1], [0, 1, 1], [1, 1, 0], [1, 0, 0],
                [0, 0, 1]]
    rng = np.random.RandomState(3)
    one = _jax_top(jcfg)
    jarena = jax.jit(jsteps.make_arena_top_step(jcfg, RT, CUT))
    jsess = [jtr.init_cache(jp, jcfg, RT, 1, max_len) for _ in range(C)]
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *jsess)
    arena_step = steps.make_arena_top_step(cfg, CUT)
    cache_a = transformer.init_cache(cfg, C, max_len)   # via arena_step
    cache_b = transformer.init_cache(cfg, C, max_len)   # via top_logits
    for active in schedule:
        active = np.asarray(active, bool)
        xbuf = rng.randn(C + 1, 1, 1, d).astype(np.float32)
        jtok, jstack = jarena(jp, jnp.asarray(xbuf), jstack,
                              jnp.asarray(active))
        tok = arena_step(tp, torch.from_numpy(xbuf), cache_a, active)
        rows = torch.as_tensor(np.flatnonzero(active))
        logits = steps.top_logits(tp, cfg, CUT, torch.from_numpy(xbuf),
                                  cache_b, rows)
        cache_b["pos"][rows] += 1
        for r in np.flatnonzero(active):
            jl, jsess[r] = one(jp, jnp.asarray(xbuf[r]), jsess[r])
            np.testing.assert_allclose(logits[r].numpy(),
                                       np.asarray(jl)[0], **TOL)
        np.testing.assert_array_equal(tok.numpy()[active],
                                      np.asarray(jtok)[active, 0])
    want_pos = np.asarray(schedule).sum(0)
    for cache in (cache_a, cache_b):
        np.testing.assert_array_equal(cache["pos"].numpy(), want_pos)
        np.testing.assert_array_equal(np.asarray(jstack["pos"]), want_pos)
        for leaf in ("k", "v"):
            want = np.asarray(jstack["kv"][leaf])
            got = cache["kv"][leaf].numpy()
            np.testing.assert_allclose(got[:, CUT:], want[:, CUT:], **TOL)
            np.testing.assert_array_equal(got[:, :CUT], 0.0)


@pytest.mark.parametrize("arch", MOE)
def test_moe_arena_row_does_not_see_the_other_rows(arch):
    """A live row's logits are the same, bit for bit, when the other arena
    rows hold other activations (zeros, which tie the router to the lowest
    experts, then random rows): no row takes expert capacity from another.
    Eight rows, the live one last in arrival order: routed as one group,
    the arena's capacity (5) would drop it."""
    cfg = configs.get(arch, smoke=True)
    tp = transformer.init_model(cfg, torch.Generator().manual_seed(4))
    C, d, live = 8, cfg.d_model, 7
    assert moe._capacity(C, cfg, Runtime().moe_capacity) < C
    rng = np.random.RandomState(5)
    xbuf = torch.from_numpy(rng.randn(C + 1, 1, 1, d).astype(np.float32))
    cache = transformer.init_cache(cfg, C, 6)
    others = [r for r in range(C) if r != live]
    logits = []
    for fill in (None, "zeros", "random"):
        xb = xbuf.clone()
        if fill == "zeros":
            xb[others] = 0.0
        elif fill == "random":
            xb[others] = torch.from_numpy(
                rng.randn(C - 1, 1, 1, d).astype(np.float32))
        c = {"pos": cache["pos"].clone(),
             "kv": {k: v.clone() for k, v in cache["kv"].items()}}
        logits.append(steps.top_logits(tp, cfg, CUT, xb, c,
                                        torch.as_tensor([live]))[live])
    assert torch.equal(logits[0], logits[1])
    assert torch.equal(logits[0], logits[2])


@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-moe-1b-a400m"])
def test_run_streaming_matches_reference(arch):
    assert_serving_matches_reference(*weights(arch), "randtopk", arch=arch)


def test_serve_and_train_cli_on_a_moe_config(capsys):
    out = serve_cli.main(["--arch", "granite-moe-1b-a400m", "--smoke",
                          "--device", "cpu", "--clients", "2",
                          "--prompt-len", "4", "--gen", "6", "--split",
                          "topk", "--k", "8"])
    assert out.shape == (2, 6)
    text = capsys.readouterr().out
    assert "B/client/token" in text and "on cpu" in text
    train_cli.main(["--arch", "granite-moe-1b-a400m", "--smoke", "--device",
                    "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
                    "--split", "randtopk", "--k", "16", "--log-every", "1"])
    text = capsys.readouterr().out
    assert "arch=granite-moe-1b-a400m" in text and "aux=" in text
