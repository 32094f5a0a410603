"""Port parity: the recurrent families, zamba2-7b (hybrid: Mamba2 layers
and a shared attention block every `attn_every` layers) and rwkv6-1.6b
(ssm: RWKV6), at SMOKE in f32 from the JAX reference's weights.

  * the registry: FULL and SMOKE field for field the reference's, and
    `tests/test_arch_smoke.py`'s assertions on FULL;
  * the converted tree keeps the reference's layout leaf for leaf;
  * the blocks alone: `ssm.mamba` (and one SSD chunk) and
    `rwkv.rwkv_time_mix` in both `rwkv_mode`s against the reference's,
    and the port's chunk form against its own scan
    (`tests/test_distributed.py`'s check);
  * the full forward and the split forward (topk at the cut);
  * one training step (randtopk at the cut, the reference's draws handed
    across as in `test_torch_training.py`);
  * the client's bottom step over a KV ring that wraps, and the server's
    arena top step over three slots with a changing active set, where an
    inactive row's state (h, conv, S, x_tm, x_cm, KV) stays bit-unchanged;
  * `run_streaming` tokens and bytes, and under eviction (`capacity=1`);
  * decode token by token equals the full-sequence forward;
  * zamba2 at cut 1, where the bottom range [0, 1) holds no shared
    attention site: the reference raises there (an IndexError inside
    `lax.cond`), so the port's split decode is held to the reference's
    unsplit `decode_layers(0, L)` instead;
  * the serving and training CLIs on rwkv6.

The split cases cut zamba2 at 2 (one shared-attention site on each side:
SMOKE has attn_every 2) and rwkv6 at 1 (SMOKE has 2 layers).

Tolerances: positions and tokens exact. Activations, logits and state
within rtol 1e-5 and atol 5e-6 (`TOL`): `test_torch_families.py`'s
atol of 1e-6 is loosened because the recurrences reorder their sums.
The reference leaves the order of its multi-operand einsums (the SSD
chunk's five-operand product, the WKV chunk's batched products) to XLA,
while the port writes a fixed chain of two-operand products, and the
error then compounds through the recurrent state: logits of magnitude ~1
differ by up to ~2e-6. One SSD chunk alone, fed N(0, 1) operands, sums
c x N products of magnitude ~1 that can cancel, so its atol is 1e-5 of
its largest output. Training within `test_torch_training.py`'s
tolerances; decode against the full forward within
`tests/test_distributed.py`'s 2e-3.
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
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm
from repro.models import transformer as jtr
from repro.models.config import Runtime as JRuntime
from repro.models.config import SplitConfig as JSplit
from repro.optim import adamw_init as jadamw_init
from repro.runtime import steps as jsteps
from repro.split import model as jsplit_model
from test_torch_serving_parity import (GEN, N_CLIENTS, PROMPT_LEN, SEED,
                                       assert_serving_matches_reference,
                                       weights)
from test_torch_training import (_assert_params, _batch,
                                 _inject_reference_draws, _sorted)
from repro_torch import configs
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import steps as lsteps
from repro_torch.launch import train as train_cli
from repro_torch.models import rwkv, ssm, transformer
from repro_torch.models.config import Runtime, SplitConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime import engine, steps
from repro_torch.split import model as split_model
from repro_torch.split import protocol

ARCHS = ["zamba2-7b", "rwkv6-1.6b"]
CUT = {"zamba2-7b": 2, "rwkv6-1.6b": 1}
STATE = {"zamba2-7b": ("mamba", "kv"), "rwkv6-1.6b": ("rwkv",)}
TOL = dict(rtol=1e-5, atol=5e-6)
RT = JRuntime(mesh=None, training=False)
LR = 1e-3
# tests/test_arch_smoke.py's assertions on the reference's FULL configs
FULL = {
    "zamba2-7b": dict(n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
                      d_ff=14336, vocab=32000, ssm_state=64),
    "rwkv6-1.6b": dict(n_layers=24, d_model=2048, d_ff=7168, vocab=65536),
}


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg = jconfigs.get(arch, smoke=True)
    cfg = configs.get(arch, smoke=True)
    jp = jtr.init_model(jax.random.key(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return arch, jcfg, cfg, jp, tp


def _np(t):
    return t.detach().numpy()


def _layer0(jp, tp, key=None):
    """Layer 0's weights in both packages (of `key`'s block, if named)."""
    jl = jax.tree.map(lambda a: a[0], jp["layers"])
    tl = transformer.layer_params(tp, 0)
    return (jl, tl) if key is None else (jl[key], tl[key])


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_reference_configs(arch, smoke):
    cfg, jcfg = configs.get(arch, smoke=smoke), jconfigs.get(arch,
                                                             smoke=smoke)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert (cfg.d_inner, cfg.ssm_heads) == (jcfg.d_inner, jcfg.ssm_heads)
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
    if cfg.family == "hybrid":     # the reference's constants
        for key, val in (("A_log", 0.0), ("D", 1.0), ("dt_bias", -2.0)):
            assert bool((fresh["layers"][key] == val).all()), key
    else:
        assert bool((fresh["layers"]["time"]["w0"] == -0.7).all())


@pytest.mark.parametrize("chunk", [8, 32])
def test_mamba_matches_reference(chunk):
    """One Mamba2 mixer over (2, 32, d), in chunks of 8 (four chunks, the
    state carried across) and 32 (one); and one SSD chunk alone from a
    nonzero state."""
    jcfg = jconfigs.get("zamba2-7b", smoke=True)
    cfg = configs.get("zamba2-7b", smoke=True)
    jp, tp = weights("zamba2-7b")
    jl, tl = _layer0(jp, tp)
    x = 0.5 * np.random.RandomState(1).randn(2, 32, cfg.d_model).astype(
        np.float32)
    want = jssm.mamba(jl, jcfg, JRuntime(mesh=None, ssm_chunk=chunk,
                                         remat=False), jnp.asarray(x))
    with torch.no_grad():
        got = ssm.mamba(tl, cfg, Runtime(ssm_chunk=chunk),
                        torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)

    rng = np.random.RandomState(2)
    B, c, H, P, N = 2, chunk, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    h = rng.randn(B, H, P, N).astype(np.float32)
    xs = rng.randn(B, c, H, P).astype(np.float32)
    b, cm = (rng.randn(B, c, N).astype(np.float32) for _ in range(2))
    dt = rng.rand(B, c, H).astype(np.float32)
    la = -rng.rand(B, c, H).astype(np.float32)
    jh, jy = jssm._ssd_chunk(jnp.asarray(h), tuple(map(jnp.asarray, (
        xs, b, cm, dt, la))), H=H, Pd=P, N=N)
    th, ty = ssm.ssd_chunk(*map(torch.from_numpy, (h, xs, b, cm, dt, la)))
    for got, want in ((th, jh), (ty, jy)):
        want = np.asarray(want)
        np.testing.assert_allclose(_np(got), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("mode", ["chunk", "scan"])
def test_rwkv_time_mix_matches_reference(mode):
    """The time-mix over (2, 64, d) in chunks of 16: output and the final
    WKV state."""
    jcfg = jconfigs.get("rwkv6-1.6b", smoke=True)
    cfg = configs.get("rwkv6-1.6b", smoke=True)
    jp, tp = weights("rwkv6-1.6b")
    jl, tl = _layer0(jp, tp, "time")
    x = 0.5 * np.random.RandomState(1).randn(2, 64, cfg.d_model).astype(
        np.float32)
    want, (jS, _) = jrwkv.rwkv_time_mix(
        jl, jcfg, JRuntime(mesh=None, rwkv_mode=mode, rwkv_chunk=16,
                           remat=False), jnp.asarray(x))
    with torch.no_grad():
        got, S = rwkv.rwkv_time_mix(tl, cfg, Runtime(rwkv_mode=mode,
                                                     rwkv_chunk=16),
                                    torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(S), np.asarray(jS), **TOL)


def test_rwkv_chunk_matches_scan():
    """`tests/test_distributed.py`'s check on the port: the chunk form
    against the exact recurrence, atol 2e-5 (the chunk form clamps each
    step's log decay to [-5, 0])."""
    cfg = configs.get("rwkv6-1.6b", smoke=True)
    tp = transformer.init_model(cfg, torch.Generator().manual_seed(0))
    p = transformer.layer_params(tp, 0)["time"]
    x = 0.5 * torch.randn((2, 64, cfg.d_model),
                          generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        yc, Sc = rwkv.rwkv_time_mix(p, cfg, Runtime(rwkv_mode="chunk"), x)
        ys, Ss = rwkv.rwkv_time_mix(p, cfg, Runtime(rwkv_mode="scan"), x)
    np.testing.assert_allclose(_np(yc), _np(ys), atol=2e-5)
    np.testing.assert_allclose(_np(Sc), _np(Ss), atol=2e-5)


def test_forward_and_split_forward_match_reference(model):
    arch, jcfg, cfg, jp, tp = model
    jb, tb = _batch(cfg, 0)
    jl, ja = jtr.forward(jp, jcfg, RT, jb)
    with torch.no_grad():
        logits, aux = transformer.forward(tp, cfg, Runtime(training=False),
                                          tb)
    np.testing.assert_allclose(_np(logits), np.asarray(jl), **TOL)
    assert float(aux) == float(ja) == 0.0

    split = dict(cut_layer=CUT[arch], compressor="topk", k=16)
    jsl, _ = jsplit_model.forward(
        jp, jcfg.with_(split=JSplit(**split)), RT, jb, key=jax.random.key(1))
    with torch.no_grad():
        sl, _ = split_model.forward(tp, cfg.with_(split=SplitConfig(
            **split)), Runtime(training=False), tb)
    np.testing.assert_allclose(_np(sl), np.asarray(jsl), **TOL)


def test_train_step_matches_reference(model, monkeypatch):
    """One AdamW step, randtopk k 16 at the cut: loss, grad norm and every
    updated parameter (the shared attention block's included)."""
    arch, jcfg, cfg, jp, tp = model
    split = dict(cut_layer=CUT[arch], compressor="randtopk", k=16,
                 alpha=0.3)
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
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    _assert_params(_sorted(jp2), _sorted(tp2), 1)


def _ref_view(kind, a):
    """A reference per-session cache leaf in the port's per-row layout:
    the recurrent states drop their batch axis of 1 (KV keeps it)."""
    a = np.asarray(a)
    return a if kind == "kv" else a[:, 0]


def _leaves(cache, kinds):
    return [(f"{kind}.{name}", kind, name, t)
            for kind in kinds for name, t in cache[kind].items()]


def _split_index(cfg, cut, kind):
    """How many entries of a state kind's stacked axis belong to the
    bottom range [0, cut): layers, or the hybrid's attention sites."""
    if kind == "kv" and cfg.family == "hybrid":
        return sum(s >= 0 for s in transformer.attn_sites(cfg)[:cut])
    return cut


def test_bottom_step_matches_reference(model):
    """Seven tokens through a ring of five cache slots, so zamba2's shared
    attention KV wraps: the cut activation and the bottom range's state;
    the top range's state stays zero."""
    arch, jcfg, cfg, jp, tp = model
    cut, max_len, toks = CUT[arch], 5, [3, 17, 400, 9, 9, 250, 1]
    bottom = jax.jit(jsteps.make_bottom_step(jcfg, RT, cut, JC.Compressor()))
    jcache = jtr.init_cache(jp, jcfg, RT, 1, max_len)
    cache = transformer.init_cache(cfg, 1, max_len)
    for t in toks:
        tok = np.asarray([[t]], np.int32)
        payload, jcache = bottom(jp, jcache, jnp.asarray(tok))
        x = steps.bottom_hidden(tp, cfg, cut, cache, tok)
        np.testing.assert_allclose(_np(x), np.asarray(payload.values), **TOL)
    assert int(cache["pos"][0]) == int(jcache["pos"]) == len(toks)
    for label, kind, name, t in _leaves(cache, STATE[arch]):
        want, got = _ref_view(kind, jcache[kind][name]), _np(t[0])
        n = _split_index(cfg, cut, kind)
        assert n > 0, label
        np.testing.assert_allclose(got[:n], want[:n], err_msg=label, **TOL)
        np.testing.assert_array_equal(got[n:], 0.0, err_msg=label)


def _jax_top(jcfg, cut):
    def one(params, x, cache):
        x, partial = jtr.decode_layers(params, jcfg, RT, x, cache, cut,
                                       jcfg.n_layers)
        logits = jtr.lm_head(params, jcfg, RT, x)
        return logits, jsteps._merge_range(cache, partial, prefix=False)
    return jax.jit(one)


def test_arena_top_step_matches_reference(model):
    """Three slots, each with its own position, and a changing active set:
    active rows' logits and tokens, the server's state and every slot's
    position; a top step leaves every leaf of an inactive row
    bit-unchanged."""
    arch, jcfg, cfg, jp, tp = model
    cut, C, max_len, d = CUT[arch], 3, 6, cfg.d_model
    schedule = [[1, 1, 1], [1, 0, 1], [0, 1, 1], [1, 1, 0], [1, 0, 0],
                [0, 0, 1]]
    rng = np.random.RandomState(3)
    one = _jax_top(jcfg, cut)
    jarena = jax.jit(jsteps.make_arena_top_step(jcfg, RT, cut))
    jsess = [jtr.init_cache(jp, jcfg, RT, 1, max_len) for _ in range(C)]
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *jsess)
    arena_step = steps.make_arena_top_step(cfg, cut)
    cache = transformer.init_cache(cfg, C, max_len)
    for active in schedule:
        active = np.asarray(active, bool)
        before = [(label, t.clone()) for label, _, _, t in
                  _leaves(cache, STATE[arch])]
        xbuf = rng.randn(C + 1, 1, 1, d).astype(np.float32)
        jtok, jstack = jarena(jp, jnp.asarray(xbuf), jstack,
                              jnp.asarray(active))
        tok = arena_step(tp, torch.from_numpy(xbuf), cache, active)
        for (label, old), (_, _, _, new) in zip(
                before, _leaves(cache, STATE[arch])):
            for r in np.flatnonzero(~active):
                assert torch.equal(new[r], old[r]), (label, r)
            for r in np.flatnonzero(active):
                assert not torch.equal(new[r], old[r]), (label, r)
        np.testing.assert_array_equal(tok.numpy()[active],
                                      np.asarray(jtok)[active, 0])
        for r in np.flatnonzero(active):
            jl, jsess[r] = one(jp, jnp.asarray(xbuf[r]), jsess[r])
            assert int(jnp.argmax(jl[0, -1])) == int(tok[r])
    want_pos = np.asarray(schedule).sum(0)
    np.testing.assert_array_equal(cache["pos"].numpy(), want_pos)
    np.testing.assert_array_equal(np.asarray(jstack["pos"]), want_pos)
    for label, kind, name, t in _leaves(cache, STATE[arch]):
        n = _split_index(cfg, cut, kind)
        for r in range(C):
            want = _ref_view(kind, jstack[kind][name][r])
            np.testing.assert_allclose(_np(t[r])[n:], want[n:],
                                       err_msg=label, **TOL)
            np.testing.assert_allclose(
                _np(t[r])[n:], _ref_view(kind, jsess[r][kind][name])[n:],
                err_msg=label, **TOL)
            np.testing.assert_array_equal(_np(t[r])[:n], 0.0,
                                          err_msg=label)


@pytest.mark.parametrize("arch", ARCHS)
def test_run_streaming_matches_reference(arch):
    assert_serving_matches_reference(*weights(arch), "randtopk", arch=arch,
                                     cut=CUT[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_eviction_run_matches_reference(arch):
    """One arena slot for three sessions: every switch evicts a row's whole
    recurrent state to the host and restores it; tokens and bytes still
    equal the reference's run at capacity 1."""
    got = assert_serving_matches_reference(
        *weights(arch), "randtopk", arch=arch, cut=CUT[arch], capacity=1)
    ev = got["metrics"]["slot_evictions_total"]["series"][0]["value"]
    assert ev > 0


def _decode_logits(tp, cfg, toks, max_len):
    """Token-by-token decode of toks (B, S) through every layer."""
    cache = transformer.init_cache(cfg, toks.shape[0], max_len)
    outs = []
    with torch.no_grad():
        for i in range(toks.shape[1]):
            x = transformer.embed(tp, cfg, toks[:, i:i + 1])
            x = transformer.decode_layers(tp, cfg, x, cache, 0, cfg.n_layers)
            cache["pos"] += 1
            outs.append(transformer.lm_head(tp, cfg, x))
    return torch.cat(outs, dim=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """`tests/test_distributed.py`'s decode checks on the port: eight
    tokens decoded one at a time give the full-sequence forward's logits
    (zamba2 in SSD chunks of 8), atol and rtol 2e-3."""
    cfg = configs.get(arch, smoke=True)
    tp = transformer.init_model(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 8),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        full, _ = transformer.forward(
            tp, cfg, Runtime(training=False, ssm_chunk=8), {"tokens": toks})
    dec = _decode_logits(tp, cfg, toks, 16)
    np.testing.assert_allclose(_np(dec), _np(full), atol=2e-3, rtol=2e-3)


def test_zamba2_split_at_cut_1_matches_unsplit_reference():
    """zamba2 at cut 1: the bottom range [0, 1) holds no shared-attention
    site (the reference's split decode raises there). The port's bottom
    decode [0, 1), the identity codec and its top decode [1, 4) give the
    reference's unsplit `decode_layers(0, L)` activations token by token,
    through a KV ring that wraps."""
    jcfg = jconfigs.get("zamba2-7b", smoke=True)
    cfg = configs.get("zamba2-7b", smoke=True)
    jp, tp = weights("zamba2-7b")
    assert transformer.attn_sites(cfg)[0] < 0
    comp = protocol.make_cut_compressor(SplitConfig(cut_layer=1,
                                                    compressor="identity"))
    max_len, toks = 5, [3, 17, 400, 9, 9, 250, 1]
    jcache = jtr.init_cache(jp, jcfg, RT, 1, max_len)
    bottom = transformer.init_cache(cfg, 1, max_len)
    top = transformer.init_cache(cfg, 1, max_len)
    rows = torch.as_tensor([0])
    for t in toks:
        tok = np.asarray([[t]], np.int32)
        jx, partial = jtr.decode_layers(jp, jcfg, RT, jtr.embed(
            jp, jcfg, RT, jnp.asarray(tok)), jcache, 0, jcfg.n_layers)
        jcache = dict(jcache, **partial, pos=jcache["pos"] + 1)
        with torch.no_grad():
            x = steps.bottom_hidden(tp, cfg, 1, bottom, tok)
            view = comp.decode(comp.encode(x, training=False),
                               dtype=x.dtype)
            assert torch.equal(view, x)
            y = transformer.decode_layers(tp, cfg, view, top, 1,
                                          cfg.n_layers, rows)
            top["pos"] += 1
        np.testing.assert_allclose(_np(y), np.asarray(jx), **TOL)


def _reference_greedy(jp, jcfg, prompts, gen):
    """The reference's unsplit greedy decode of each prompt (its
    `decode_step`, all sessions in one batch)."""
    B, P = prompts.shape
    cache = jtr.init_cache(jp, jcfg, RT, B, P + gen)
    step = jax.jit(lambda p, t, c: jtr.decode_step(p, jcfg, RT, t, c))
    tok, out = jnp.asarray(prompts[:, :1]), []
    for i in range(P + gen - 1):
        logits, cache = step(jp, tok, cache)
        nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        if i + 1 < P:
            tok = jnp.asarray(prompts[:, i + 1:i + 2])
        else:
            out.append(np.asarray(nxt))
            tok = nxt[:, None]
    return np.stack(out, axis=1)


def test_zamba2_served_at_cut_1_matches_unsplit_reference():
    """`run_streaming` serves zamba2 at cut 1 (identity codec) without
    error, and its tokens are the reference's unsplit greedy decode."""
    jcfg = jconfigs.get("zamba2-7b", smoke=True)
    cfg = configs.get("zamba2-7b", smoke=True).with_(split=SplitConfig(
        cut_layer=1, compressor="identity"))
    jp, tp = weights("zamba2-7b")
    prompts = np.random.RandomState(SEED).randint(
        0, cfg.vocab, (N_CLIENTS, PROMPT_LEN)).astype(np.int32)
    got = engine.run_streaming(cfg, params=tp, prompts=prompts,
                               n_clients=N_CLIENTS, prompt_len=PROMPT_LEN,
                               gen=GEN, device="cpu")
    want = _reference_greedy(jp, jcfg, prompts, GEN)
    np.testing.assert_array_equal(got["tokens"], want)


def test_serve_cli_on_rwkv6(capsys):
    out = serve_cli.main(["--arch", "rwkv6-1.6b", "--smoke", "--device",
                          "cpu", "--clients", "2", "--prompt-len", "4",
                          "--gen", "6", "--split", "randtopk", "--k", "16"])
    assert out.shape == (2, 6)
    text = capsys.readouterr().out
    assert "B/client/token" in text and "on cpu" in text


def test_train_cli_on_rwkv6(capsys):
    train_cli.main(["--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu",
                    "--steps", "2", "--batch", "2", "--seq", "16",
                    "--split", "randtopk", "--k", "16", "--log-every", "1"])
    text = capsys.readouterr().out
    assert "arch=rwkv6-1.6b" in text and "loss" in text
