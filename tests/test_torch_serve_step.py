"""Port parity: the whole-batch serve step (`launch.steps.make_serve_step`,
`split.model.decode_step`, `models.transformer.decode_step`) against the
reference's jitted `make_serve_step` and `split.model.decode_step`, at
SMOKE in f32 on the CPU, one torch thread, from the reference's weights
(`models.convert.params_from_jax`).

Every config of the reference's families, and yi-6b with the int8 KV
cache (`kv_cache_bits=8`: the reference's `Runtime.kv_cache_bits`, the
port's `init_cache(bits=8)`), split randtopk k 16: B 4 prompts of 3
tokens from `np.random.RandomState`, then 8 greedy tokens. Each step
feeds the reference's decode step and serve step the same cache (it
returns new caches), and the port's two steps one cache each (written
in place). The tokens must be equal; the logits within 1e-4 absolute,
1e-3 for rwkv6 (the f32 conditioning both packages share, ROADMAP
Queue 3). At inference RandTopK encodes as TopK, so no draw crosses.

Cuts: 1, but the vlm at `cross_attn_every` (a range holds whole groups)
and zamba2 at 2: at cut 1 the bottom range holds no shared-attention
site and the reference raises (an IndexError inside `lax.cond`,
`tests/test_torch_recurrent.py`). The vlm's gates are at 0.5 and its
caches hold the rows' patches, whisper's their encoder output. Further
cases: a sliding window of 4 whose ring wraps, and yi-6b without a split
(`transformer.decode_step`).

The reference's moe decode step routes the batch as one group, the
port's each row alone; at B 4 the capacity (at least 4) holds every
token, so both keep every pair.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.launch import steps as jlsteps
from repro.models import transformer as jtr
from repro.models.config import Runtime as JRuntime
from repro.models.config import SplitConfig as JSplit
from repro.split import model as jsplit_model
from test_torch_multimodal import set_gates
from repro_torch import configs
from repro_torch.launch import steps
from repro_torch.models import transformer
from repro_torch.models.config import Runtime, SplitConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.split import model as split_model

B, PROMPT, GEN, MAX_LEN = 4, 3, 8, 16
K = 16
ATOL = {"rwkv6-1.6b": 1e-3}
# (case id, arch, cut, config changes, KV cache bits)
CASES = [
    ("yi-6b", "yi-6b", 1, {}, 16),
    ("qwen3-8b", "qwen3-8b", 1, {}, 16),
    ("granite-moe", "granite-moe-1b-a400m", 1, {}, 16),
    ("qwen3-moe", "qwen3-moe-235b-a22b", 1, {}, 16),
    ("zamba2", "zamba2-7b", 2, {}, 16),
    ("rwkv6", "rwkv6-1.6b", 1, {}, 16),
    ("vlm", "llama-3.2-vision-90b", None, {}, 16),
    ("whisper", "whisper-tiny", 1, {}, 16),
    ("yi-6b-int8-kv", "yi-6b", 1, {}, 8),
    ("yi-6b-window-4", "yi-6b", 1, {"sliding_window": 4}, 16),
    ("yi-6b-no-split", "yi-6b", 0, {}, 16),
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, cut, kw):
    jcfg = jconfigs.get(arch, smoke=True).with_(**kw)
    cfg = configs.get(arch, smoke=True).with_(**kw)
    if cut is None:
        cut = cfg.cross_attn_every
    if cut:
        split = dict(cut_layer=cut, compressor="randtopk", k=K)
        jcfg, cfg = jcfg.with_(split=JSplit(**split)), cfg.with_(
            split=SplitConfig(**split))
    return jcfg, cfg


def _extras(jcfg, cfg, jp, tp, rt, jrt):
    """Both packages' side inputs of the B rows: the vlm's patches,
    whisper's encoder output (each package's encoder over the same
    frames); none for the other families."""
    if cfg.family not in ("vlm", "audio"):
        return None, None
    name, n = (("patches", cfg.n_image_tokens) if cfg.family == "vlm"
               else ("frames", cfg.n_frames))
    side = (np.random.RandomState(7).randn(B, n, cfg.d_model)
            * 0.02).astype(np.float32)
    jex = jtr.make_extras(jp, jcfg, jrt, {name: jnp.asarray(side)})
    with torch.no_grad():
        ex = transformer.make_extras(tp, cfg, rt, {name: torch.from_numpy(
            side)})
    return jex, ex


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_serve_step_matches_reference(case):
    _, arch, cut, kw, bits = case
    jcfg, cfg = _configs(arch, cut, kw)
    npp = jax.tree.map(np.asarray, jtr.init_model(jax.random.key(0), jcfg))
    if cfg.family == "vlm":
        npp = set_gates(npp, 0.5)
    jp = jax.tree.map(jnp.asarray, npp)
    tp = params_from_jax(npp, cfg, "cpu")
    jrt = JRuntime(mesh=None, training=False, kv_cache_bits=bits)
    rt = Runtime(training=False)
    jex, ex = _extras(jcfg, cfg, jp, tp, rt, jrt)
    jcache = jtr.init_cache(jp, jcfg, jrt, B, MAX_LEN, extras_batch=jex)
    cache = transformer.init_cache(cfg, B, MAX_LEN, bits=bits, params=tp,
                                   extras=ex)
    cache2 = transformer.init_cache(cfg, B, MAX_LEN, bits=bits, params=tp,
                                    extras=ex)
    jdecode = jax.jit(lambda p, c, t: jsplit_model.decode_step(
        p, jcfg, jrt, t, c))
    jserve = jax.jit(jlsteps.make_serve_step(jcfg, jrt))
    serve = steps.make_serve_step(cfg, rt)
    prompts = np.random.RandomState(3).randint(
        0, cfg.vocab, (B, PROMPT)).astype(np.int32)
    atol = ATOL.get(arch, 1e-4)
    nxt, generated = None, []
    for i in range(PROMPT - 1 + GEN):
        tok = prompts[:, i:i + 1] if i < PROMPT else nxt
        jl, jcache_next = jdecode(jp, jcache, jnp.asarray(tok))
        jt, _ = jserve(jp, jcache, jnp.asarray(tok))
        jcache = jcache_next
        logits, out = split_model.decode_step(tp, cfg, rt,
                                              torch.from_numpy(tok), cache)
        assert out is cache
        toks, out2 = serve(tp, cache2, torch.from_numpy(tok))
        assert out2 is cache2
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=0,
                                   atol=atol)
        assert toks.shape == (B, 1)
        np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
        nxt = np.asarray(jt).astype(np.int32)
        if i >= PROMPT - 1:
            generated.append(nxt)
    assert int(jcache["pos"]) == PROMPT - 1 + GEN
    for c in (cache, cache2):
        assert c["pos"].tolist() == [PROMPT - 1 + GEN] * B
    assert np.concatenate(generated, 1).shape == (B, GEN)
