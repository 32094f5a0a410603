"""Port parity, end to end: closed-loop streaming serve of yi-6b SMOKE (f32)
through `repro_torch.runtime.engine.run_streaming` on the CPU against the
JAX reference's `run_streaming` (`test_torch_serving_parity`), for the sparse
payload kinds. The dense and quant kinds are in
`test_torch_serving_dense.py`, so the two files run in parallel.

Also the entry points' device contract (the card by default; the CPU only
when asked) and the serving CLI.
"""
import numpy as np
import pytest
import torch

from test_torch_serving_parity import assert_serving_matches_reference, weights
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models.config import SplitConfig
from repro_torch.runtime import engine


@pytest.fixture(scope="module")
def params():
    return weights()


@pytest.mark.parametrize("comp", ["topk", "randtopk", "randtopk_mask"])
def test_served_tokens_and_bytes_match_reference(params, comp):
    assert_serving_matches_reference(*params, comp)


def test_run_streaming_defaults_to_the_card(monkeypatch):
    """No `device`: the card; without CUDA that raises instead of falling
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get("yi-6b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.run_streaming(cfg, n_clients=1, prompt_len=1, gen=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke", "--clients", "1", "--gen", "1"])


def test_serve_cli_on_the_cpu(capsys):
    out = serve.main(["--smoke", "--device", "cpu", "--clients", "2",
                      "--prompt-len", "2", "--gen", "3", "--split",
                      "randtopk", "--k", "16"])
    assert out.shape == (2, 3)
    text = capsys.readouterr().out
    assert "on cpu" in text
    assert "80.0 B/client/token measured payload" in text   # 16 * (32+8)/8
    assert "80.0 B analytic (randtopk)" in text


def test_mixed_compressor_flushes_match_pure_runs():
    """A sparse and a dense client population in one run: flushes that
    hold both payload kinds take the server's per-meta decode path, and
    each client's tokens equal those of a run of its compressor alone."""
    cfg = configs.get("yi-6b", smoke=True).with_(
        split=SplitConfig(cut_layer=1, compressor="topk", k=16))
    prompts = np.random.default_rng(5).integers(0, cfg.vocab, (4, 2))
    kw = dict(n_clients=4, prompt_len=2, gen=3, seed=1, prompts=prompts,
              device="cpu", max_wait=0.05)
    mixed = engine.run_streaming(cfg, compressor_mix=["topk:k=16",
                                                      "identity"], **kw)
    assert mixed["compressors"] == ["topk", "identity"] * 2
    for i, comp in enumerate(["topk:k=16", "identity"]):
        pure = engine.run_streaming(cfg, compressor_mix=[comp], **kw)
        np.testing.assert_array_equal(mixed["tokens"][i::2],
                                      pure["tokens"][i::2])


def test_random_prompts_and_weights_are_seeded():
    cfg = configs.get("yi-6b", smoke=True).with_(
        split=SplitConfig(cut_layer=1, compressor="topk", k=8))
    kw = dict(n_clients=2, prompt_len=2, gen=2, device="cpu")
    a = engine.run_streaming(cfg, seed=3, **kw)["tokens"]
    b = engine.run_streaming(cfg, seed=3, **kw)["tokens"]
    np.testing.assert_array_equal(a, b)
