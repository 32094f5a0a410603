"""Port parity of serving and the CLIs for the vision and audio families
(llama-3.2-vision-90b, whisper-tiny) at SMOKE in f32, every `gate` at 0.5
(`test_torch_multimodal.py` says why):

  * the client's bottom step over a KV ring that wraps, and the server's
    arena top step over three slots with a changing active set, each
    from caches whose cross KV is that of the sessions' own patches or
    encoder output (nonzero): the cut activation, tokens, logits and KV
    equal the reference's; a top step leaves an inactive row's KV
    bit-unchanged and nobody's cross KV moves;
  * `run_streaming` tokens and bytes equal the reference's, and at
    `capacity=1`, where every switch evicts a row (its cross KV with
    it) to the host and restores it. `run_streaming` builds its caches
    without extras, so the cross KV is that of zeros on both sides, as
    the reference serves;
  * the serving and training CLIs on both archs; a vlm cut is rounded
    down to whole groups of `cross_attn_every` layers, and a vlm depth
    that is not whole groups is refused.

Tolerances as in `test_torch_multimodal.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as JC
from repro.models import transformer as jtr
from repro.runtime import steps as jsteps
from test_torch_multimodal import (ARCHS, CUT, RT, TOL, _n_self, _np,
                                   gated_weights, side_input)
from test_torch_serving_parity import assert_serving_matches_reference
from repro_torch import configs
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer
from repro_torch.models.config import Runtime
from repro_torch.runtime import steps


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return (request.param,) + gated_weights(request.param)


def _extras(model, rows, seed):
    """Both packages' extras (`make_extras`) for `rows` sessions' own
    patches or frames."""
    _, jcfg, cfg, jp, tp = model
    name, side = side_input(cfg, rows, seed)
    jex = jtr.make_extras(jp, jcfg, RT, {name: jnp.asarray(side)})
    with torch.no_grad():
        ex = transformer.make_extras(tp, cfg, Runtime(training=False),
                                     {name: torch.from_numpy(side)})
    return jex, ex


def _row(jex, r):
    return {k: v[r:r + 1] for k, v in jex.items()}


def test_bottom_step_matches_reference(model):
    """Seven tokens through a ring of five cache slots: the cut
    activation and the bottom range's KV; the top range's KV stays zero
    and the cross KV is never written."""
    arch, jcfg, cfg, jp, tp = model
    cut, max_len, toks = CUT[arch], 5, [3, 17, 400, 9, 9, 250, 1]
    jex, ex = _extras(model, 1, 9)
    bottom = jax.jit(jsteps.make_bottom_step(jcfg, RT, cut, JC.Compressor()))
    jcache = jtr.init_cache(jp, jcfg, RT, 1, max_len, extras_batch=jex)
    cache = transformer.init_cache(cfg, 1, max_len, params=tp, extras=ex)
    ckv0 = cache["cross_kv"].clone()
    for t in toks:
        tok = np.asarray([[t]], np.int32)
        payload, jcache = bottom(jp, jcache, jnp.asarray(tok))
        x = steps.bottom_hidden(tp, cfg, cut, cache, tok)
        np.testing.assert_allclose(_np(x), np.asarray(payload.values), **TOL)
    assert int(cache["pos"][0]) == int(jcache["pos"]) == len(toks)
    n = _n_self(cfg, cut)
    for leaf in ("k", "v"):
        want = np.asarray(jcache["kv"][leaf])       # (n, 1, size, H, hd)
        got = _np(cache["kv"][leaf][0])             # (n, 1, size, H, hd)
        np.testing.assert_allclose(got[:n], want[:n], **TOL)
        np.testing.assert_array_equal(got[n:], 0.0)
    assert torch.equal(cache["cross_kv"], ckv0)
    assert float(ckv0.abs().max()) > 0


def test_arena_top_step_matches_reference(model):
    """Three slots, each with its own position and its own patches or
    encoder output, and a changing active set: active rows' logits and
    tokens, the server's KV and every slot's position; a top step leaves
    an inactive row's KV bit-unchanged, and the cross KV of every row."""
    arch, jcfg, cfg, jp, tp = model
    cut, C, max_len, d = CUT[arch], 3, 6, cfg.d_model
    schedule = [[1, 1, 1], [1, 0, 1], [0, 1, 1], [1, 1, 0], [1, 0, 0],
                [0, 0, 1]]
    jex, ex = _extras(model, C, 10)
    rng = np.random.RandomState(3)

    def one(params, x, cache):
        x, partial = jtr.decode_layers(params, jcfg, RT, x, cache, cut,
                                       jcfg.n_layers)
        return (jtr.lm_head(params, jcfg, RT, x),
                jsteps._merge_range(cache, partial, prefix=False))

    one = jax.jit(one)
    jarena = jax.jit(jsteps.make_arena_top_step(jcfg, RT, cut))
    jsess = [jtr.init_cache(jp, jcfg, RT, 1, max_len,
                            extras_batch=_row(jex, r)) for r in range(C)]
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *jsess)
    arena_step = steps.make_arena_top_step(cfg, cut)
    cache = transformer.init_cache(cfg, C, max_len, params=tp, extras=ex)
    np.testing.assert_allclose(_np(cache["cross_kv"]),
                               np.asarray(jstack["cross_kv"]), **TOL)
    ckv0 = cache["cross_kv"].clone()
    for active in schedule:
        active = np.asarray(active, bool)
        before = {k: t.clone() for k, t in cache["kv"].items()}
        xbuf = rng.randn(C + 1, 1, 1, d).astype(np.float32)
        jtok, jstack = jarena(jp, jnp.asarray(xbuf), jstack,
                              jnp.asarray(active))
        tok = arena_step(tp, torch.from_numpy(xbuf), cache, active)
        for k, old in before.items():
            for r in range(C):
                assert torch.equal(cache["kv"][k][r], old[r]) == \
                    (not active[r]), (k, r)
        assert torch.equal(cache["cross_kv"], ckv0)
        np.testing.assert_array_equal(tok.numpy()[active],
                                      np.asarray(jtok)[active, 0])
        for r in np.flatnonzero(active):
            jl, jsess[r] = one(jp, jnp.asarray(xbuf[r]), jsess[r])
            assert int(jnp.argmax(jl[0, -1])) == int(tok[r])
    want_pos = np.asarray(schedule).sum(0)
    np.testing.assert_array_equal(cache["pos"].numpy(), want_pos)
    np.testing.assert_array_equal(np.asarray(jstack["pos"]), want_pos)
    n = _n_self(cfg, cut)
    for leaf in ("k", "v"):
        got = _np(cache["kv"][leaf])
        for r in range(C):
            for want in (np.asarray(jstack["kv"][leaf][r]),
                         np.asarray(jsess[r]["kv"][leaf])):
                np.testing.assert_allclose(got[r][n:], want[n:], **TOL)
            np.testing.assert_array_equal(got[r][:n], 0.0)


@pytest.mark.parametrize("capacity", [None, 1], ids=["resident", "evicted"])
@pytest.mark.parametrize("arch", ARCHS)
def test_run_streaming_matches_reference(arch, capacity):
    _, _, jp, tp = gated_weights(arch)
    got = assert_serving_matches_reference(jp, tp, "randtopk", arch=arch,
                                           cut=CUT[arch], capacity=capacity)
    if capacity == 1:
        ev = got["metrics"]["slot_evictions_total"]["series"][0]["value"]
        assert ev > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_and_train_cli(arch, capsys):
    out = serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--clients", "2", "--prompt-len", "3", "--gen",
                          "4", "--split", "randtopk", "--k", "16"])
    assert out.shape == (2, 4)
    text = capsys.readouterr().out
    assert "B/client/token" in text and "on cpu" in text
    # the vlm's cut 3 rounds down to its group of 2; whisper's 2 layers
    # take the default, 1
    vlm = arch == "llama-3.2-vision-90b"
    train_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                    "2", "--batch", "2", "--seq", "16", "--split",
                    "randtopk", "--k", "16", "--cut", "3" if vlm else "0",
                    "--log-every", "1"])
    text = capsys.readouterr().out
    assert f"arch={arch}" in text and "step     1" in text
    assert f"cut_layer={2 if vlm else 1}," in text


def test_vlm_cut_and_depth_round_to_groups():
    cfg = configs.get("llama-3.2-vision-90b")
    assert configs.cut_for(cfg) == 50
    assert configs.cut_for(configs.with_layers(cfg, 10)) == 5
    assert configs.cut_for(configs.with_layers(cfg, 15)) == 5
    assert configs.cut_for(cfg, 7) == 5 and configs.cut_for(cfg, 3) == 5
    assert configs.cut_for(configs.get("whisper-tiny")) == 2
    assert train_cli.build("llama-3.2-vision-90b", smoke=True,
                           split="randtopk", cut=3).split.cut_layer == 2
    with pytest.raises(ValueError, match="multiple of cross_attn_every"):
        configs.with_layers(cfg, 12)
    with pytest.raises(ValueError, match="multiple of cross_attn_every"):
        serve_cli.main(["--arch", "llama-3.2-vision-90b", "--smoke",
                        "--layers", "3", "--device", "cpu"])
