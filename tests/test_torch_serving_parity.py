"""Shared end-to-end check of the port's streaming serve against the JAX
reference, used by `test_torch_serving.py`, `test_torch_serving_dense.py`
and `test_torch_families.py`: a SMOKE config in f32 (yi-6b unless named),
the same config, seed, weights and prompts on both sides."""
import jax
import numpy as np

import repro.configs as jconfigs
from repro.models import transformer as jtr
from repro.models.config import SplitConfig as JSplit
from repro.runtime import engine as jengine
from repro_torch import configs
from repro_torch.models.config import SplitConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import engine
from repro_torch.split import protocol

N_CLIENTS, PROMPT_LEN, GEN, SEED = 3, 3, 4, 0


def weights(arch="yi-6b"):
    """(reference params, the port's converted copy)."""
    jp = jtr.init_model(jax.random.key(SEED), jconfigs.get(arch, smoke=True))
    tp = params_from_jax(jax.tree.map(np.asarray, jp),
                         configs.get(arch, smoke=True), "cpu")
    return jp, tp


def assert_serving_matches_reference(jp, tp, comp: str, k: int = 16,
                                     arch="yi-6b", cut: int = 1, cfg_kw=None,
                                     **run_kw):
    """Served tokens and every client's measured bytes equal the
    reference's; the server never densifies a payload on the host.
    `cfg_kw` changes both configs alike (e.g. `kv_cache_bits`); `run_kw`
    goes to both `run_streaming` calls (e.g. `capacity`). Returns the
    port's result."""
    split = dict(cut_layer=cut, compressor=comp, k=k)
    jcfg = jconfigs.get(arch, smoke=True).with_(split=JSplit(**split),
                                                **(cfg_kw or {}))
    cfg = configs.get(arch, smoke=True).with_(split=SplitConfig(**split),
                                              **(cfg_kw or {}))
    kw = dict(n_clients=N_CLIENTS, prompt_len=PROMPT_LEN, gen=GEN, seed=SEED,
              **run_kw)
    want = jengine.run_streaming(jcfg, params=jp, **kw)
    # the reference draws its prompts with jax.random (engine.py:172-173)
    prompts = np.asarray(jax.random.randint(
        jax.random.key(SEED + 1), (N_CLIENTS, PROMPT_LEN), 0, jcfg.vocab))
    before = protocol.HOST_DENSIFY_COUNT.value
    got = engine.run_streaming(cfg, params=tp, prompts=prompts,
                               device="cpu", **kw)
    assert protocol.HOST_DENSIFY_COUNT.value == before
    assert got["tokens"].shape == (N_CLIENTS, GEN)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    for key in ("payload_bytes_up", "header_bytes_up", "frames_up",
                "bytes_down"):
        assert [s[key] for s in got["client_stats"]] == \
            [s[key] for s in want["client_stats"]], key
        assert [s[key] for s in got["server_stats"]] == \
            [s[key] for s in got["client_stats"]], key
    comp_obj = got["compressor_objs"][0]
    for s in got["client_stats"]:
        assert s["payload_bytes_up"] == s["frames_up"] * \
            comp_obj.fwd_bits(cfg.d_model) / 8
    return got
