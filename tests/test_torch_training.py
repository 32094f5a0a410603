"""Port parity: the training slice (`split.protocol.cut_boundary`, the
split model's forward and `launch.steps.make_train_step`) against the JAX
reference, at yi-6b SMOKE in f32 on the CPU.

Both packages start from the same weights (the reference's, converted) and
the same numpy batch. RandTopK's randomness crosses as data: the test
computes in JAX exactly the draws the reference makes for a step key
(`kb, kg = split(key)`, `binomial_nontop_count(kb, ...)`,
`gumbel(kg, x.shape)`, as in `repro/core/selection.py:148-151`) and hands
them to the port by replacing its `selection.binomial_nontop_count` and
`selection.gumbel_noise`.

Tolerances: masks and sparse/slice/mask views are exact; quant views are
within 1 ulp at the largest magnitude (the reference's dequant
convention); input gradients within 1e-6 absolute and the test's summed
loss within 1e-5 (the sums run in another order); step losses within rtol
1e-5, grad norms within rtol 1e-4. Updated parameters: all but 1e-4 of
each tensor's elements within 1e-2 * lr plus rtol 1e-5, and every element
within the 2 * lr per step that AdamW can move a weight at most. AdamW's
first steps move each weight by about lr * g / (|g| + eps), so the rare
gradient near eps whose last bits differ moves its weight by a visibly
different fraction of lr.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.core import selection as jsel
from repro.launch import steps as jsteps
from repro.models import transformer as jtransformer
from repro.models.config import Runtime as JRuntime
from repro.models.config import SplitConfig as JSplitConfig
from repro.optim import adamw_init as jadamw_init
from repro.split import protocol as jprotocol
from repro_torch import configs
from repro_torch.core import selection
from repro_torch.launch import steps
from repro_torch.launch import train as train_cli
from repro_torch.models import convert, transformer
from repro_torch.models.config import Runtime, SplitConfig
from repro_torch.optim.adamw import adamw_init, tree_leaves
from repro_torch.split import protocol

COMPRESSORS = [
    ("none", {}), ("topk", {"k": 5}), ("randtopk", {"k": 5}),
    ("randtopk_mask", {"k": 5}), ("size_reduction", {"k": 5}),
    ("quant", {"quant_bits": 4}), ("l1", {}),
    ("randtopk_quant", {"k": 5, "quant_bits": 8}),
]
IDS = [c[0] for c in COMPRESSORS]
ALPHA = 0.3
LR = 1e-3


def _inject_reference_draws(monkeypatch, key, alpha, k, shape):
    """Make the port's next RandTopK draws the reference's for `key`."""
    kb, kg = jax.random.split(key)
    d = shape[-1]
    m = np.asarray(jsel.binomial_nontop_count(kb, alpha, k, d, shape[:-1]))
    g = np.asarray(jax.random.gumbel(kg, shape, dtype=jnp.float32))
    monkeypatch.setattr(selection, "binomial_nontop_count",
                        lambda *a, **kw: torch.from_numpy(m.copy()))
    monkeypatch.setattr(selection, "gumbel_noise",
                        lambda *a, **kw: torch.from_numpy(g.copy()))


def _assert_view(name, want, got):
    if "quant" in name:
        atol = float(np.spacing(np.float32(np.abs(want).max())))
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,kw", COMPRESSORS, ids=IDS)
def test_cut_boundary_view_and_input_grad_match_reference(monkeypatch, name,
                                                          kw):
    """Forward view (exact, quant within 1 ulp), L1 penalty and the input
    gradient of sum(view * w) + penalty, against the reference's
    `_transport` custom VJP with the same draws."""
    B, S, d = 2, 3, 24
    rng = np.random.RandomState(0)
    x = rng.randn(B, S, d).astype(np.float32)
    w = rng.randn(B, S, d).astype(np.float32)
    jcfg = jconfigs.get("yi-6b", smoke=True).with_(
        d_model=d, split=JSplitConfig(cut_layer=1, compressor=name,
                                      alpha=ALPHA, **kw))
    key = jax.random.key(5)

    def jloss(xx):
        y, pen = jprotocol.cut_boundary(xx, jcfg, JRuntime(), key)
        return jnp.sum(y * w) + pen, y

    (jl, jy), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    _inject_reference_draws(monkeypatch, key, ALPHA, kw.get("k", 0),
                            (B, S, d))
    cfg = configs.get("yi-6b", smoke=True).with_(
        d_model=d, split=SplitConfig(cut_layer=1, compressor=name,
                                     alpha=ALPHA, **kw))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, pen = protocol.cut_boundary(xt, cfg, Runtime(), torch.Generator())
    loss = torch.sum(y * torch.from_numpy(w)) + pen
    loss.backward()
    _assert_view(name, np.asarray(jy), y.detach().numpy())
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-6)


def _smoke_pair(name, kw, cut=1):
    jcfg = jconfigs.get("yi-6b", smoke=True).with_(split=JSplitConfig(
        cut_layer=cut, compressor=name, alpha=ALPHA, **kw))
    cfg = configs.get("yi-6b", smoke=True).with_(split=SplitConfig(
        cut_layer=cut, compressor=name, alpha=ALPHA, **kw))
    jparams = jtransformer.init_model(jax.random.key(0), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, convert.params_from_jax(np_params, cfg, "cpu")


def _batch(cfg, step, B=2, S=16):
    rng = np.random.RandomState(100 + step)
    tokens = rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    return ({"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)})


def _assert_params(jparams, params, n_steps):
    want = jax.tree_util.tree_leaves(
        jax.tree.map(np.asarray, jparams))
    got = [t.detach().numpy() for t in tree_leaves(params)]
    # both trees flatten in sorted-key order for these dicts
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.shape == b.shape
        diff = np.abs(b - a)
        assert diff.max() <= 2 * LR * n_steps
        close = diff <= 1e-5 * np.abs(a) + 1e-2 * LR
        assert close.mean() >= 1 - 1e-4, (close.size - close.sum(),
                                          diff.max())


def _sorted(tree):
    return ({k: _sorted(tree[k]) for k in sorted(tree)}
            if isinstance(tree, dict) else tree)


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("name,kw", [("randtopk", {"k": 16}),
                                     ("randtopk_mask", {"k": 16}),
                                     ("quant", {"quant_bits": 4}),
                                     ("size_reduction", {"k": 16})],
                         ids=["randtopk", "randtopk_mask", "quant",
                              "size_reduction"])
def test_train_steps_match_reference(monkeypatch, name, kw, n_steps):
    """yi-6b SMOKE f32, cut at layer 1: loss, grad norm and the updated
    parameters after 1 and after 3 AdamW steps."""
    jcfg, cfg, jparams, params = _smoke_pair(name, kw)
    jrt = JRuntime(training=True)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jrt, lr=LR))
    step = steps.make_train_step(cfg, Runtime(training=True), lr=LR)
    jopt, opt = jadamw_init(jparams), adamw_init(params)
    for i in range(n_steps):
        jb, tb = _batch(cfg, i)
        key = jax.random.fold_in(jax.random.key(1), i)
        _inject_reference_draws(monkeypatch, key, ALPHA, kw.get("k", 0),
                                (2, 16, cfg.d_model))
        jparams, jopt, jm = jstep(jparams, jopt, jb, key)
        params, opt, m = step(params, opt, tb, torch.Generator())
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    _assert_params(_sorted(jparams), _sorted(params), n_steps)
    assert int(opt["step"]) == n_steps


def test_remat_changes_nothing():
    """Recomputing the layers in the backward (torch.utils.checkpoint, the
    cut outside it) gives the same loss and gradients as keeping the
    activations, with the same RandTopK draws."""
    _, cfg, _, params = _smoke_pair("randtopk", {"k": 16})
    _, tb = _batch(cfg, 0)
    out = []
    for remat in (True, False):
        p = {k: v for k, v in params.items()}
        gen = torch.Generator().manual_seed(3)
        step = steps.make_train_step(cfg, Runtime(remat=remat), lr=LR)
        new, _, m = step(p, adamw_init(params), tb, gen)
        out.append((float(m["loss"]), [t.detach() for t in
                                       tree_leaves(new)]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_eval_step_and_full_forward_match_reference():
    jcfg, cfg, jparams, params = _smoke_pair("randtopk", {"k": 16})
    jb, tb = _batch(cfg, 7)
    want = jsteps.make_eval_step(jcfg, JRuntime(training=False))(jparams, jb)
    got = steps.make_eval_step(cfg, Runtime(training=False))(params, tb)
    np.testing.assert_allclose(float(got["ce"]), float(want["ce"]),
                               rtol=1e-5)
    assert float(got["acc"]) == float(want["acc"])
    jl, _ = jtransformer.forward(jparams, jcfg.with_(split=None),
                                 JRuntime(), jb)
    tl, _ = transformer.forward(params, cfg.with_(split=None), Runtime(), tb)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,kw", [("identity", {})] + COMPRESSORS[1:],
                         ids=["identity"] + IDS[1:])
def test_wire_bytes_per_step_match_reference(name, kw):
    jcfg = jconfigs.get("yi-6b", smoke=True).with_(split=JSplitConfig(
        cut_layer=1, compressor=name, **kw))
    cfg = configs.get("yi-6b", smoke=True).with_(split=SplitConfig(
        cut_layer=1, compressor=name, **kw))
    for training in (True, False):
        assert protocol.wire_bytes_per_step(cfg, 2, 8, training=training) \
            == jprotocol.wire_bytes_per_step(jcfg, 2, 8, training=training)
    assert protocol.measured_payload_bytes(cfg, 2, 8) == \
        jprotocol.measured_payload_bytes(jcfg, 2, 8)


def test_train_cli_runs_on_cpu(capsys):
    train_cli.main(["--arch", "yi-6b", "--smoke", "--device", "cpu",
                    "--steps", "3", "--batch", "2", "--seq", "16",
                    "--split", "randtopk", "--k", "16", "--log-every", "1"])
    out = capsys.readouterr().out
    assert out.count("step ") == 3 and "cut-layer wire/step" in out


def test_train_cli_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--smoke", "--steps", "1"])


@pytest.mark.parametrize("name,kw", [("identity", {})] + COMPRESSORS[1:],
                         ids=["identity"] + IDS[1:])
def test_out_of_process_training_halves_match_reference(monkeypatch, name,
                                                        kw):
    """`server_grad_encode` (the wire gradient the forward kind dictates),
    `client_grad_decode` (routed onto the forward support) and
    `server_decode_device`, from one forward payload: exact, quant views
    within 1 ulp."""
    from repro.core import compressors as JC
    from repro_torch.core import compressors as C

    rng = np.random.RandomState(1)
    x = rng.randn(3, 20).astype(np.float32)
    g = rng.randn(3, 20).astype(np.float32)
    key = jax.random.key(2)
    ckw = {"k": kw["k"]} if "k" in kw else {}
    if "quant_bits" in kw:
        ckw["bits"] = kw["quant_bits"]
    jc, tc = JC.make_compressor(name, **ckw), C.make_compressor(name, **ckw)
    jp = jprotocol.client_encode(jc, jnp.asarray(x), key=key, training=True)
    _inject_reference_draws(monkeypatch, key, getattr(jc, "alpha", 0.0),
                            ckw.get("k", 0), x.shape)
    tp = protocol.client_encode(tc, torch.from_numpy(x),
                                generator=torch.Generator(), training=True)
    for f in ("values", "indices", "header"):
        a, b = getattr(jp, f), getattr(tp, f)
        assert (a is None) == (b is None)
    jgp = jprotocol.server_grad_encode(jp, g)
    tgp = protocol.server_grad_encode(tp, g)
    assert tgp.meta == type(tgp.meta)(**vars(jgp.meta))
    np.testing.assert_array_equal(tgp.values, np.asarray(jgp.values))
    want = np.asarray(jprotocol.client_grad_decode(
        jgp, fwd_kind=jp.meta.kind, indices=jp.indices, d=20))
    got = protocol.client_grad_decode(tgp, fwd_kind=tp.meta.kind,
                                      indices=tp.indices, d=20)
    np.testing.assert_array_equal(got.numpy(), want)
    _assert_view(name, np.asarray(jprotocol.server_decode_device(jp)),
                 protocol.server_decode_device(tp, device="cpu").numpy())
