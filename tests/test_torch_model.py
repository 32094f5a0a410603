"""Port parity: the dense decoder at yi-6b SMOKE in f32, from the JAX
reference's own weights (`models.convert.params_from_jax`).

  * bottom step (client, layers [0, cut)): the cut activation of every
    token, the client's KV layers and `pos`;
  * arena top step (server, layers [cut, L) + LM head) over three slots
    with their own positions and a changing active set: the logits of each
    active row, the greedy tokens, the server's KV layers and every slot's
    `pos` — inactive slots keep both.

Activations, logits and KV within rtol 1e-5, atol 1e-6 (f32 products
accumulate in another order in the two frameworks); positions and tokens
exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.core import compressors as JC
from repro.models import transformer as jtr
from repro.models.config import Runtime
from repro.runtime import steps as jsteps
from repro_torch import configs
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import steps

CUT = 1
TOL = dict(rtol=1e-5, atol=1e-6)
RT = Runtime(mesh=None, training=False)


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.get("yi-6b", smoke=True)
    cfg = configs.get("yi-6b", smoke=True)
    jp = jtr.init_model(jax.random.key(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp, tp


def test_converted_params_keep_the_reference_layout(model):
    jcfg, cfg, jp, tp = model
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == 12
    for path, leaf in flat_j:
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    bf = params_from_jax(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.bfloat16)), jp),
        cfg.with_(param_dtype="bfloat16"), "cpu")
    np.testing.assert_array_equal(
        bf["embed"].float().numpy(),
        np.asarray(jp["embed"].astype(jnp.bfloat16).astype(jnp.float32)))


def test_bottom_step_matches_reference(model):
    """Seven tokens through a ring of five cache slots, so the ring wraps."""
    jcfg, cfg, jp, tp = model
    max_len, toks = 5, [3, 17, 400, 9, 9, 250, 1]
    bottom = jax.jit(jsteps.make_bottom_step(jcfg, RT, CUT, JC.Compressor()))
    jcache = jtr.init_cache(jp, jcfg, RT, 1, max_len)
    cache = transformer.init_cache(cfg, 1, max_len)
    for t in toks:
        tok = np.asarray([[t]], np.int32)
        payload, jcache = bottom(jp, jcache, jnp.asarray(tok))
        x = steps.bottom_hidden(tp, cfg, CUT, cache, tok)
        assert x.shape == (1, 1, cfg.d_model)
        np.testing.assert_allclose(x.numpy(), np.asarray(payload.values),
                                   **TOL)
    assert int(cache["pos"][0]) == int(jcache["pos"]) == len(toks)
    for leaf in ("k", "v"):
        want = np.asarray(jcache["kv"][leaf])           # (L, 1, size, H, hd)
        got = cache["kv"][leaf][0].numpy()
        np.testing.assert_allclose(got[:CUT], want[:CUT], **TOL)
        np.testing.assert_array_equal(got[CUT:], 0.0)   # the server's layers


def _jax_top(jcfg):
    """The reference's per-session top half, returning its logits."""
    def one(params, x, cache):
        x, partial = jtr.decode_layers(params, jcfg, RT, x, cache, CUT,
                                       jcfg.n_layers)
        logits = jtr.lm_head(params, jcfg, RT, x)
        return logits, jsteps._merge_range(cache, partial, prefix=False)
    return jax.jit(one)


def test_arena_top_step_matches_reference(model):
    jcfg, cfg, jp, tp = model
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
        np.testing.assert_array_equal(
            tok.numpy(), torch.argmax(logits[:, -1], -1).numpy())
    want_pos = np.asarray(schedule).sum(0)
    for cache in (cache_a, cache_b):
        np.testing.assert_array_equal(cache["pos"].numpy(), want_pos)
        np.testing.assert_array_equal(np.asarray(jstack["pos"]), want_pos)
        for leaf in ("k", "v"):
            want = np.asarray(jstack["kv"][leaf])   # (C, L, 1, size, H, hd)
            got = cache["kv"][leaf].numpy()
            np.testing.assert_allclose(got[:, CUT:], want[:, CUT:], **TOL)
            np.testing.assert_array_equal(got[:, :CUT], 0.0)
            for r in range(C):
                np.testing.assert_allclose(
                    got[r], np.asarray(jsess[r]["kv"][leaf]), **TOL)
