"""Port parity: the explicit two-party tabular trainer
(`repro_torch.split.tabular`) against the JAX reference's
`repro.split.tabular`, on the CPU.

Both packages start from the reference's `init_parties` weights
(converted) and see the same numpy batches. For the randomized methods
the test computes in JAX the draws the reference makes from each step key
(`kb, kg = split(sub)`, `binomial_nontop_count(kb, ...)`,
`gumbel(kg, x.shape)`, `tabular.py:248` and `selection.py:148-151`) and
hands them to the port by replacing its `selection.binomial_nontop_count`
and `selection.gumbel_noise`.

Tolerances: losses within rtol 1e-5; parameters after 3 AdamW steps
within 1e-2 * lr plus rtol 1e-4 for all but 1e-3 of each tensor's
elements and within 2 * lr per step for every element (AdamW's first
steps move a weight by about lr * sign(grad), so a gradient at the
rounding floor can move it by another fraction of lr); accuracies within
2 test samples (an argmax between two near-equal logits may flip);
measured and Table-2 bytes exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import selection as jsel
from repro.data.synthetic import ManyClassDataset as JDataset
from repro.optim import adamw_init as jadamw_init
from repro.split import tabular as jtab
from repro_torch.core import selection
from repro_torch.data.synthetic import ManyClassDataset
from repro_torch.models.convert import parties_from_jax
from repro_torch.optim.adamw import adamw_init
from repro_torch.split import tabular

METHODS = ["none", "topk", "randtopk", "randtopk_mask", "size_reduction",
           "quant", "l1", "randtopk_quant"]
RANDOM = ("randtopk", "randtopk_mask", "randtopk_quant")
LR = 1e-3


def _spec(method, mod):
    return mod.SplitSpec(in_dim=16, hidden=32, cut_dim=24, n_classes=10,
                         method=method, k=5, alpha=0.3, quant_bits=4,
                         lr=LR)


def _parties(spec, seed=0):
    jb, jt = jtab.init_parties(jax.random.key(seed), spec)
    np_b, np_t = (jax.tree.map(np.asarray, p) for p in (jb, jt))
    return (jb, jt), parties_from_jax(np_b, np_t, "cpu")


def _inject(monkeypatch, key, spec, batch):
    kb, kg = jax.random.split(key)
    shape = (batch, spec.cut_dim)
    m = np.asarray(jsel.binomial_nontop_count(kb, spec.alpha, spec.k,
                                              spec.cut_dim, (batch,)))
    g = np.asarray(jax.random.gumbel(kg, shape, dtype=jnp.float32))
    monkeypatch.setattr(selection, "binomial_nontop_count",
                        lambda *a, **kw: torch.from_numpy(m.copy()))
    monkeypatch.setattr(selection, "gumbel_noise",
                        lambda *a, **kw: torch.from_numpy(g.copy()))


def _assert_close_params(jparams, params, n_steps):
    for name, a in jparams.items():
        a = np.asarray(a)
        b = params[name].detach().numpy()
        diff = np.abs(b - a)
        assert diff.max() <= 2 * LR * n_steps, name
        close = diff <= 1e-4 * np.abs(a) + 1e-2 * LR
        assert close.mean() >= 1 - 1e-3, (name, diff.max())


@pytest.mark.parametrize("method", METHODS)
def test_steps_evaluate_and_bytes_match_reference(monkeypatch, method):
    """Three explicit two-party steps (loss each step, parameters after
    the last), then `evaluate` and `measured_step_bytes` on the result."""
    jspec, spec = _spec(method, jtab), _spec(method, tabular)
    (jb, jt), (b, t) = _parties(jspec)
    jstep, step = jtab.make_train_step(jspec), tabular.make_train_step(spec)
    jo_b, jo_t = jadamw_init(jb), jadamw_init(jt)
    o_b, o_t = adamw_init(b), adamw_init(t)
    ds = JDataset(n_classes=10, in_dim=16, n_train=96, n_test=64, seed=3)
    rng = np.random.RandomState(0)
    key = jax.random.key(7)
    for xb, yb in list(ds.batches(32, rng=rng)):
        key, sub = jax.random.split(key)
        if method in RANDOM:
            _inject(monkeypatch, sub, spec, 32)
        jb, jt, jo_b, jo_t, jloss = jstep(jb, jt, jo_b, jo_t,
                                          jnp.asarray(xb), jnp.asarray(yb),
                                          sub)
        b, t, o_b, o_t, loss = step(b, t, o_b, o_t, torch.from_numpy(xb),
                                    torch.from_numpy(yb), torch.Generator())
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_close_params(jb, b, 3)
    _assert_close_params(jt, t, 3)
    want = jtab.evaluate(jb, jt, jspec, jnp.asarray(ds.x_test),
                         jnp.asarray(ds.y_test))
    got = tabular.evaluate(b, t, spec, torch.from_numpy(ds.x_test),
                           torch.from_numpy(ds.y_test))
    assert abs(got - want) <= 2 / len(ds.y_test)
    o = tabular.bottom_fn(b, torch.from_numpy(ds.x_train[:32]))
    if method in RANDOM:
        _inject(monkeypatch, key, spec, 32)
    assert tabular.measured_step_bytes(spec, o, generator=torch.Generator()) \
        == jtab.measured_step_bytes(jspec, jnp.asarray(o.detach().numpy()),
                                    key=key)
    for training in (True, False):
        assert tabular.wire_bytes(spec, 32, training=training) == \
            jtab.wire_bytes(jspec, 32, training=training)


@pytest.mark.parametrize("method", ["none", "topk", "size_reduction",
                                    "quant"])
def test_train_matches_reference(method):
    """`train` end to end for one epoch from the reference's initial
    weights: the step count, both byte accountings (and the 5% byte
    assertion inside `train`), and the accuracies."""
    jspec, spec = _spec(method, jtab), _spec(method, tabular)
    ds = ManyClassDataset(n_classes=10, in_dim=16, n_train=256, n_test=128,
                          seed=1)
    jds = JDataset(n_classes=10, in_dim=16, n_train=256, n_test=128, seed=1)
    np.testing.assert_array_equal(ds.x_train, jds.x_train)
    want = jtab.train(jspec, jds, epochs=1, batch=32, seed=0)
    _, params = _parties(jspec, seed=0)
    got = tabular.train(spec, ds, epochs=1, batch=32, seed=0,
                        device="cpu", params=params)
    assert got["steps"] == 8
    for k in ("train_bytes", "train_bytes_measured", "compressed_size_pct"):
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    for k in ("test_acc", "train_acc"):
        assert abs(got[k] - want[k]) <= 2 / 128, k


def test_randtopk_train_runs_and_keeps_byte_contract():
    """The randomized trainer draws from its own generator (no reference
    draws): it runs, and its byte assertion holds."""
    ds = ManyClassDataset(n_classes=10, in_dim=16, n_train=128, n_test=64)
    out = tabular.train(_spec("randtopk", tabular), ds, epochs=1, batch=32,
                        device="cpu", record_every=2)
    assert out["steps"] == 4 and len(out["trace"]) == 2
    assert out["train_bytes_measured"] == pytest.approx(
        out["train_bytes"], rel=0.05)


def test_train_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tabular.train(_spec("none", tabular), ManyClassDataset(
            n_classes=10, in_dim=16, n_train=64, n_test=32), epochs=1)
