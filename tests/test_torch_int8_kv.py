"""Port parity: the label owner's int8 KV arena (`ArchConfig.
kv_cache_bits=8`) against the JAX reference.

  * the cache layout: int8 k/v, f32 per-(token, head) scales shaped as
    k without its last axis (`tests/test_arena.py`'s layout test);
  * `attention.quantize_kv` against the reference's `_quantize_kv` on
    random rows, rows at half-code ties and zero rows: codes and scales
    exactly equal;
  * yi-6b SMOKE decode through every layer at bits=8, token by token
    through a ring that wraps: the cached codes exactly equal to the
    reference's, logits within rtol 1e-5 and atol 1e-6 (the dense
    families' tolerance, `test_torch_families.py`), scales within rtol
    1e-6 (a few ulps: they are max |k| / 127 of projections whose f32
    matmuls XLA and torch sum in different orders, so even layer 0's k
    can differ in its last bits; fed the same k, the scales are exact, as
    the test above holds);
  * the arena top step over three slots at bits=8: an inactive row's
    codes and scales stay bit-unchanged;
  * `run_streaming` with `cfg.with_(kv_cache_bits=8)` gives the
    reference's tokens and bytes at the same arguments (yi-6b at cut 1,
    zamba2's shared-attention sites at cut 2);
  * the clients keep 16-bit caches: only the server's arena is int8.

The reference's own accuracy test (`test_int8_kv_arena_serving_accuracy_
delta`) asserts that int8 tokens differ from the 16-bit run's, which does
not hold at its seed; nothing here relies on that claim.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro.models.config import Runtime as JRuntime
from test_torch_serving_parity import (assert_serving_matches_reference,
                                       weights)
from repro_torch import configs
from repro_torch.models import attention, transformer
from repro_torch.models.config import SplitConfig
from repro_torch.runtime import engine, steps

RT8 = JRuntime(mesh=None, training=False, kv_cache_bits=8)
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ["yi-6b", "zamba2-7b"])
def test_int8_cache_layout(arch):
    cfg = configs.get(arch, smoke=True)
    kv = transformer.init_cache(cfg, 3, 8, bits=8)["kv"]
    assert kv["k"].dtype == kv["v"].dtype == torch.int8
    assert kv["k_scale"].dtype == kv["v_scale"].dtype == torch.float32
    assert kv["k_scale"].shape == kv["k"].shape[:-1]
    jcfg = jconfigs.get(arch, smoke=True)
    jp = jtr.init_model(jax.random.key(0), jcfg)
    jkv = jtr.init_cache(jp, jcfg, RT8, 1, 8)["kv"]
    assert sorted(jkv) == sorted(kv)
    for name, leaf in jkv.items():          # per session: (n, 1, size, ...)
        assert tuple(kv[name].shape[1:]) == leaf.shape, name
        assert str(kv[name].dtype).split(".")[-1] == str(leaf.dtype), name
    assert set(transformer.init_cache(cfg, 1, 8)["kv"]) == {"k", "v"}
    with pytest.raises(ValueError, match="bits"):
        transformer.init_cache(cfg, 1, 8, bits=4)


def test_quantize_kv_matches_reference():
    """Random rows, rows whose codes land on .5 ties (round half to even),
    a zero row (the 1e-9 floor) and a row with one large element."""
    rng = np.random.RandomState(0)
    x = rng.randn(4, 1, 3, 64).astype(np.float32)
    x[1, 0, 0] = np.arange(64, dtype=np.float32) - 31.5    # many .5 codes
    x[1, 0, 1] = 0.0
    x[2, 0, 2] = 0.01 * x[2, 0, 2]
    x[2, 0, 2, 5] = 3.0
    jc, js = jattn._quantize_kv(jnp.asarray(x))
    tc, ts = attention.quantize_kv(torch.from_numpy(x))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert int(tc.abs().max()) == 127 and bool((tc[1, 0, 1] == 0).all())
    np.testing.assert_array_equal(
        attention.dequantize_kv(tc, ts, torch.float32).numpy(),
        np.asarray(jattn._dequantize_kv(jc, js, jnp.float32)))


def test_int8_decode_matches_reference():
    """yi-6b SMOKE, every layer, seven tokens through a ring of five
    slots: logits, then every cached code and scale."""
    jcfg = jconfigs.get("yi-6b", smoke=True)
    cfg = configs.get("yi-6b", smoke=True)
    jp, tp = weights("yi-6b")
    max_len, toks = 5, [3, 17, 400, 9, 9, 250, 1]
    step = jax.jit(lambda p, t, c: jtr.decode_step(p, jcfg, RT8, t, c))
    jcache = jtr.init_cache(jp, jcfg, RT8, 1, max_len)
    cache = transformer.init_cache(cfg, 1, max_len, bits=8)
    for t in toks:
        tok = np.asarray([[t]], np.int32)
        jl, jcache = step(jp, jnp.asarray(tok), jcache)
        with torch.no_grad():
            x = transformer.embed(tp, cfg, torch.from_numpy(tok))
            x = transformer.decode_layers(tp, cfg, x, cache, 0,
                                          cfg.n_layers)
            cache["pos"] += 1
            logits = transformer.lm_head(tp, cfg, x)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_array_equal(cache["kv"][name][0].numpy(),
                                      np.asarray(jcache["kv"][name]),
                                      err_msg=name)
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(cache["kv"][name][0].numpy(),
                                   np.asarray(jcache["kv"][name]),
                                   rtol=1e-6, atol=0, err_msg=name)


def test_int8_arena_top_step_keeps_inactive_rows():
    """Three slots at bits=8 and a changing active set: an inactive row's
    codes, scales and position stay bit-unchanged, an active row's move."""
    cfg = configs.get("yi-6b", smoke=True)
    tp = transformer.init_model(cfg, torch.Generator().manual_seed(0))
    C, cut = 3, 1
    cache = transformer.init_cache(cfg, C, 6, bits=8)
    arena_step = steps.make_arena_top_step(cfg, cut)
    rng = np.random.RandomState(3)
    for active in ([1, 1, 1], [1, 0, 1], [0, 1, 0], [0, 0, 1]):
        active = np.asarray(active, bool)
        before = {k: v.clone() for k, v in cache["kv"].items()}
        pos = cache["pos"].clone()
        xbuf = torch.from_numpy(rng.randn(C + 1, 1, 1, cfg.d_model).astype(
            np.float32))
        with torch.no_grad():
            arena_step(tp, xbuf, cache, active)
        for name, old in before.items():
            new = cache["kv"][name]
            for r in range(C):
                assert torch.equal(new[r], old[r]) == (not active[r]), \
                    (name, r)
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      pos.numpy() + active)


@pytest.mark.parametrize("arch,cut", [("yi-6b", 1), ("zamba2-7b", 2)])
def test_run_streaming_int8_matches_reference(arch, cut):
    assert_serving_matches_reference(*weights(arch), "randtopk", arch=arch,
                                     cut=cut, cfg_kw=dict(kv_cache_bits=8))


def test_clients_keep_16bit_caches(monkeypatch):
    """In an int8 run the clients' bottom caches are built at 16 bits and
    only the server's arena (and its template row) at 8."""
    cfg = configs.get("yi-6b", smoke=True).with_(
        kv_cache_bits=8, split=SplitConfig(cut_layer=1, compressor="topk",
                                           k=8))
    make_cache, make_top_cache = engine.cache_makers(cfg, 6, "cpu")
    assert make_cache(2)["kv"]["k"].dtype == torch.float32
    assert "k_scale" not in make_cache()["kv"]
    assert make_top_cache(2)["kv"]["k"].dtype == torch.int8
    plain = engine.cache_makers(cfg.with_(kv_cache_bits=0), 6, "cpu")[1]
    assert plain()["kv"]["k"].dtype == torch.float32

    built = []
    init_cache = transformer.init_cache

    def recording(cfg_, rows, max_len, device=None, bits=16, **kw):
        built.append((rows, bits))
        return init_cache(cfg_, rows, max_len, device, bits, **kw)

    monkeypatch.setattr(transformer, "init_cache", recording)
    out = engine.run_streaming(cfg, n_clients=2, prompt_len=2, gen=2,
                               device="cpu")
    assert out["tokens"].shape == (2, 2)
    assert sorted(set(built)) == [(1, 8), (1, 16), (2, 8)]
    assert built.count((2, 8)) == 1            # the arena, once
