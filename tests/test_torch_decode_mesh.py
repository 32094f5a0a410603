"""The whole-batch serve step on a decode mesh (`Runtime.mesh`,
`tp.Layout(decode=True)`), on the CPU, every position `devices="cpu"`,
one torch thread, SMOKE in f32, split randtopk k 16 at cut 1: yi-6b,
qwen3-8b (qk-norm) and granite-moe-1b-a400m (its 4 experts over
'model', `moe_capacity` 8.0), against the port's own `mesh=None` step.

  * (1, 1) equals mesh=None bit for bit: logits, tokens, every cache
    leaf.
  * At (1, 4), (2, 2), (4, 1) and (2, 2, 2), flash decode on and off:
    the logits of `split.model.decode_step` within 2e-5 of mesh=None's
    (the reference's own mesh test allows 2e-4,
    `tests/test_distributed.py:57`) and the tokens of
    `launch.steps.make_serve_step` equal, over a 12-slot ring that 14
    steps wrap; the int8 cache; a sliding window of 8 over 'model' 4, so
    each position's 2 slots hold positions that move on as the ring
    wraps; `dp_only`, which turns flash decode off.
  * Counted collective bytes (`mesh.collective_bytes`) of every step
    equal `roofline.analysis.decode_collective_costs`, with and without
    the serve step's argmax.
  * B 1 on a 'data' axis of 2 stays whole; the pod ring returns each
    row its own token; flash decode writes a token's K and V only on the
    position whose slots hold its ring slot.

The hybrid, ssm, vlm and audio families on the decode mesh:
`tests/test_torch_decode_mesh_families.py`.
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.mesh import collective_bytes
from repro_torch.models import transformer
from repro_torch.models.config import Runtime, SplitConfig
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.roofline import analysis
from repro_torch.split import model as split_model

ARCHS = ["yi-6b", "qwen3-8b", "granite-moe-1b-a400m"]
MESHES = [("1x4", (1, 4)), ("2x2", (2, 2)), ("4x1", (4, 1)),
          ("2x2x2", (2, 2, 2))]
B, MAX_LEN, STEPS = 4, 12, 14
ATOL = 2e-5


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
        cut_layer=1, compressor="randtopk", k=16), **kw)


_PARAMS = {}


def _params(cfg):
    key = (cfg.name, cfg.family)
    if key not in _PARAMS:
        _PARAMS[key] = transformer.init_model(
            cfg, torch.Generator().manual_seed(0), device="cpu")
    return _PARAMS[key]


def _prompts(batch=B, vocab=512):
    return torch.from_numpy(np.random.RandomState(5).randint(
        0, vocab, (batch, 1)).astype(np.int64))


def _rt(mesh=None, registry=None, **kw):
    return Runtime(training=False, mesh=mesh, moe_capacity=8.0,
                   registry=registry, **kw)


def _run(cfg, mesh=None, batch=B, max_len=MAX_LEN, bits=16, **rt_kw):
    """Two chains of `STEPS` tokens from one prompt token a row: the
    serve step's greedy tokens, and `split.model.decode_step` fed those
    tokens, each with its own cache and registry. Returns (logits a
    step, tokens a step, the decode chain's cache, the serve chain's
    counted bytes a step, the decode chain's)."""
    params = _params(cfg)
    regs = (MetricsRegistry(), MetricsRegistry())
    rts = [_rt(mesh, reg, **rt_kw) for reg in regs]
    if mesh is None:
        caches = [transformer.init_cache(cfg, batch, max_len, bits=bits)
                  for _ in rts]
    else:
        caches = [transformer.init_cache_mesh(
            cfg, split_model.decode_layout(cfg, rt, batch), max_len,
            bits=bits) for rt in rts]
    serve = steps.make_serve_step(cfg, rts[0])
    tok = _prompts(batch, cfg.vocab)
    logits, toks = [], []
    for _ in range(STEPS):
        lg, _ = split_model.decode_step(params, cfg, rts[1], tok, caches[1])
        tok, _ = serve(params, caches[0], tok)
        logits.append(lg)
        toks.append(tok)
    counted = [{k: v / STEPS for k, v in collective_bytes(
        reg.snapshot()).items()} for reg in regs]
    return logits, torch.cat(toks, 1), caches[1], counted[0], counted[1]


_REF = {}


def _reference(cfg, **kw):
    key = (cfg, tuple(sorted(kw.items())))
    if key not in _REF:
        _REF[key] = _run(cfg, **kw)
    return _REF[key]


def _assert_matches(cfg, shape, flash, dp_only=False, **kw):
    mesh = _mesh(shape)
    ref_logits, ref_toks, _, _, _ = _reference(cfg, **kw)
    logits, toks, _, serve_bytes, decode_bytes = _run(
        cfg, mesh, flash_decode=flash, dp_only=dp_only, **kw)
    torch.testing.assert_close(toks, ref_toks, rtol=0, atol=0)
    for got, want in zip(logits, ref_logits):
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    batch = kw.get("batch", B)
    max_len = kw.get("max_len", MAX_LEN)
    for counted, argmax in ((serve_bytes, True), (decode_bytes, False)):
        want, _ = analysis.decode_collective_costs(
            cfg, batch, max_len, mesh.shape, flash_decode=flash,
            dp_only=dp_only, argmax=argmax)
        assert counted == want, (argmax, counted, want)
    return logits, toks


@pytest.mark.parametrize("arch", ARCHS)
def test_one_by_one_mesh_is_mesh_none_bit_for_bit(arch):
    cfg = _cfg(arch)
    ref_logits, ref_toks, ref_cache, _, _ = _reference(cfg)
    logits, toks, caches, serve_bytes, decode_bytes = _run(cfg, _mesh((1, 1)))
    assert torch.equal(toks, ref_toks)
    for got, want in zip(logits, ref_logits):
        assert torch.equal(got, want)
    (cache,) = caches
    assert torch.equal(cache["pos"], ref_cache["pos"])
    for leaf in ("k", "v"):
        assert torch.equal(cache["kv"][leaf], ref_cache["kv"][leaf])
    assert serve_bytes == decode_bytes == {}


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "replicated"])
@pytest.mark.parametrize("label,shape", MESHES, ids=[m[0] for m in MESHES])
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_matches_mesh_none(arch, label, shape, flash):
    _assert_matches(_cfg(arch), shape, flash)


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "replicated"])
@pytest.mark.parametrize("shape", [(1, 4), (2, 2, 2)], ids=["1x4", "2x2x2"])
def test_int8_cache(shape, flash):
    _assert_matches(_cfg("yi-6b"), shape, flash, bits=8)


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "replicated"])
def test_sliding_window_slots_span_positions(flash):
    """A window of 8 on a ring of 8 slots over 'model' 4: each position
    holds 2 slots, and over 14 steps the positions they hold move on."""
    cfg = _cfg("yi-6b", sliding_window=8)
    _assert_matches(cfg, (1, 4), flash, max_len=32)
    lay = split_model.decode_layout(cfg, Runtime(
        training=False, mesh=_mesh((1, 4)), flash_decode=flash), B)
    caches = transformer.init_cache_mesh(cfg, lay, 32)
    assert {c["size"] for c in caches} == {8}
    assert {c["kv"]["k"].shape[3] for c in caches} == {2 if flash else 8}


@pytest.mark.parametrize("shape", [(2, 2), (2, 2, 2)], ids=["2x2", "2x2x2"])
def test_dp_only_turns_flash_decode_off(shape):
    cfg = _cfg("yi-6b")
    rt = Runtime(training=False, mesh=_mesh(shape), dp_only=True)
    lay = split_model.decode_layout(cfg, rt, B)
    assert lay.n_model == 1 and not lay.flash
    _assert_matches(cfg, shape, True, dp_only=True)


@pytest.mark.parametrize("arch", ["yi-6b", "granite-moe-1b-a400m"])
def test_batch_of_one_stays_whole(arch):
    """B 1 on a 'data' axis of 2 does not split: both batch shards hold
    the row (the reference's `_sanitize_spec` drops the axis)."""
    cfg = _cfg(arch)
    rt = Runtime(training=False, mesh=_mesh((2, 2)))
    lay = split_model.decode_layout(cfg, rt, 1)
    assert lay.whole and lay.b_loc == 1 and len(lay.groups) == 2
    _assert_matches(cfg, (2, 2), True, batch=1)
    _assert_matches(cfg, (2, 2, 2), False, batch=1)


def test_pod_ring_returns_tokens_in_row_order():
    """At (2, 2, 2) the cut moves pod 0's rows to pod 1 and back: the
    tokens are mesh=None's row for row, not rolled by a pod's rows, and
    the tokens' way back is one collective-permute of 4 B a row of a
    shard; without `transfer_over_pod` no permute runs."""
    cfg = _cfg("yi-6b")
    ref_toks = _reference(cfg)[1]
    assert len({tuple(r) for r in ref_toks.tolist()}) == B
    _, toks = _assert_matches(cfg, (2, 2, 2), True)
    assert not torch.equal(toks, ref_toks.roll(B // 2, 0))
    mesh = _mesh((2, 2, 2))
    serve, decode = (analysis.decode_collective_costs(
        cfg, B, MAX_LEN, mesh.shape, argmax=a)[0]["collective-permute"]
        for a in (True, False))
    assert serve - decode == (B // 4) * 4
    off = cfg.with_(split=SplitConfig(cut_layer=1, compressor="randtopk",
                                      k=16, transfer_over_pod=False))
    _, _, _, counted, _ = _run(off, mesh)
    assert "collective-permute" not in counted


def test_flash_decode_writes_only_the_owning_position():
    """The first token (position 0) is written to slot 0 of every layer,
    on 'model' rank 0 alone; the token at position 5 to slot 5, rank 1's
    second slot of 3 (12 slots over 4)."""
    cfg = _cfg("yi-6b")
    rt = Runtime(training=False, mesh=_mesh((1, 4)))
    lay = split_model.decode_layout(cfg, rt, B)
    caches = transformer.init_cache_mesh(cfg, lay, MAX_LEN)
    assert [c["kv"]["k"].shape for c in caches] == \
        [(B, cfg.n_layers, 1, 3, cfg.n_kv_heads, cfg.hd)] * 4
    serve = steps.make_serve_step(cfg, rt)
    params, tok = _params(cfg), _prompts()
    for _ in range(6):
        tok, _ = serve(params, caches, tok)
    for r, c in enumerate(caches):
        written = c["kv"]["k"].abs().amax(dim=(0, 1, 2, 4, 5)) > 0
        want = [r * 3 + j <= 5 for j in range(3)]
        assert written.tolist() == want, r
        assert c["pos"].tolist() == [6] * B


def test_flash_decode_is_on_by_default():
    assert Runtime().flash_decode
    rt = Runtime(training=False, mesh=_mesh((1, 4)))
    lay = split_model.decode_layout(_cfg("yi-6b"), rt, B)
    assert lay.flash and lay.ring_split(MAX_LEN) and not lay.ring_split(6)
    off = Runtime(training=False, mesh=_mesh((1, 4)), flash_decode=False)
    assert not split_model.decode_layout(_cfg("yi-6b"), off, B).flash


def test_decode_collective_costs_by_hand():
    """yi-6b SMOKE (2 layers, d 256, 4 heads of 64, d_ff 512, padded
    vocab 512) at (1, 4), B 4, f32: per layer the three flash
    all-reduces 4 x 4 x (1 + 1 + 64) x 4 B, wo's and the MLP's sums
    4 x 256 x 4 B each, and the argmax's two 4 x 4 B."""
    cfg = _cfg("yi-6b")
    per_op, total = analysis.decode_collective_costs(
        cfg, B, MAX_LEN, {"data": 1, "model": 4})
    layer = 4 * 4 * 66 * 4 + 2 * 4 * 256 * 4
    assert per_op == {"all-reduce": float(2 * layer + 2 * 4 * 4)}
    assert total == 2 * per_op["all-reduce"]
    per_op, _ = analysis.decode_collective_costs(
        cfg, B, MAX_LEN, {"data": 1, "model": 4}, flash_decode=False,
        argmax=False)
    assert per_op == {"all-reduce": float(2 * 2 * 4 * 256 * 4)}
