"""Port parity: the paper's experiments (`repro_torch.experiments`) against
the reference's scripts in `benchmarks/`, on the CPU at a small size
(10 classes, in_dim 16, 256 training and 128 test rows, 1 epoch, 1 seed,
batch 32).

- table2: every `table2,...` line equal to the reference's, letter for
  letter (the timing line left out).
- Each training section runs for real through the port. What it returned
  at each call (a `train` result, a histogram, an MSE, a fedtrain run) is
  then replayed, in order, into the reference's script: both must print
  the same lines letter for letter, checks included, so the port emits the
  reference's keys and computes its checks by the reference's rules. The
  same comparison runs with made-up results (`_fake`) chosen so that the
  checks come out both ways.
- Sizes and byte columns of every `train` call equal the reference's
  accounting (`repro.core.wire`, `repro.split.tabular.wire_bytes`)
  exactly; l1's size is the trained model's measured support, so only its
  step count is compared.
- Deterministic pieces from the reference's weights: `fit_ef`'s parameters
  (rtol 1e-5), `attack`'s MSE (rtol 1e-4), fig5's histogram (exact) and
  entropy (1e-6), fig2 at alpha 0 and its update on given flips (1e-6).
"""
import dataclasses
import functools
import pathlib
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import alpha_sweep as r_alpha  # noqa: E402
from benchmarks import appendixB_privacy as r_privacy  # noqa: E402
from benchmarks import combined_compression as r_combined  # noqa: E402
from benchmarks import error_feedback as r_ef  # noqa: E402
from benchmarks import fedtrain_convergence as r_fed  # noqa: E402
from benchmarks import fig2_toy as r_fig2  # noqa: E402
from benchmarks import fig4_convergence as r_fig4  # noqa: E402
from benchmarks import fig5_distribution as r_fig5  # noqa: E402
from benchmarks import table2_sizes as r_table2  # noqa: E402
from benchmarks import table3_accuracy as r_table3  # noqa: E402
from benchmarks import table7_dbpedia_geometry as r_table7  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro.core import wire as jwire  # noqa: E402
from repro.core.payload import PayloadMeta as JMeta  # noqa: E402
from repro.data.synthetic import ManyClassDataset as JDataset  # noqa: E402
from repro.split import tabular as jtab  # noqa: E402
from repro_torch.core import wire  # noqa: E402
from repro_torch.core.payload import PayloadMeta  # noqa: E402
from repro_torch.data.synthetic import ManyClassDataset  # noqa: E402
from repro_torch.experiments import (alpha_sweep, appendixB_privacy,  # noqa: E402
                                     combined_compression, error_feedback,
                                     fedtrain_convergence, fig2_toy,
                                     fig4_convergence, fig5_distribution,
                                     run, table2_sizes, table3_accuracy,
                                     table7_dbpedia_geometry)
from repro_torch.models.convert import parties_from_jax  # noqa: E402
from repro_torch.split import tabular  # noqa: E402

SMALL = dict(n_classes=10, in_dim=16, n_train=256, n_test=128, noise=0.3,
             seed=0)
SMALL7 = dict(n_classes=219, in_dim=128, n_train=256, n_test=128,
              noise=0.25, seed=1)
BATCH = 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: the sections' small ops only lose to several on
    a busy machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: (section, reference module, port module)
SECTIONS = [
    ("table3", r_table3, table3_accuracy),
    ("fig4", r_fig4, fig4_convergence),
    ("fig5", r_fig5, fig5_distribution),
    ("alpha", r_alpha, alpha_sweep),
    ("combined", r_combined, combined_compression),
    ("ef", r_ef, error_feedback),
    ("table7", r_table7, table7_dbpedia_geometry),
    ("privacy", r_privacy, appendixB_privacy),
    ("fedtrain", r_fed, fedtrain_convergence),
]
#: the functions of a section whose results are recorded and replayed
RESULT_FNS = ("train", "train_ef", "selection_histogram", "attack",
              "run_fedtrain")


def _small_spec(split_spec):
    def spec(method, **kw):
        kw.setdefault("hidden", 32)
        kw.setdefault("lr", 2e-3)
        return split_spec(method=method, in_dim=16, n_classes=10, **kw)
    return spec


def _fed_setup(dataset_cls, split_spec):
    def setup(smoke):
        return (dataset_cls(n_classes=10, in_dim=16, n_train=512,
                            n_test=128, noise=0.3, seed=0),
                split_spec(in_dim=16, hidden=32, cut_dim=32, n_classes=10,
                           method="randtopk", k=9, lr=2e-3), 1)
    return setup


def _small(monkeypatch, mod, dataset_cls, split_spec):
    """Both packages' section modules at the small size: the module
    attributes the sections read (bound at import in the reference)."""
    sizes = dict(EPOCHS=1, SEEDS=1,
                 dataset=functools.partial(
                     dataset_cls, **(SMALL7 if mod.__name__.endswith(
                         "table7_dbpedia_geometry") else SMALL)),
                 spec=_small_spec(split_spec),
                 _setup=_fed_setup(dataset_cls, split_spec))
    for name, value in sizes.items():
        if hasattr(mod, name):
            monkeypatch.setattr(mod, name, value)
    if hasattr(mod, "run_method"):
        monkeypatch.setattr(mod.run_method, "__defaults__",
                            (1,) + mod.run_method.__defaults__[1:])


def _call(main, emit, port):
    kw = {"device": "cpu"} if port else {}
    if main.__module__.endswith("fedtrain_convergence"):
        kw["smoke"] = True
    return main(emit=emit, **kw)


def _replay(monkeypatch, mod, results):
    queue = list(results)

    def replay(*args, **kw):
        return queue.pop(0)
    for name in RESULT_FNS:
        if hasattr(mod, name):
            monkeypatch.setattr(mod, name, replay)
    return queue


@pytest.mark.parametrize("section,ref,port", SECTIONS,
                         ids=[s[0] for s in SECTIONS])
def test_section_runs_and_prints_the_reference_lines(monkeypatch, section,
                                                     ref, port):
    """The port's section trains for real at the small size; its results,
    replayed into the reference's script, give the port's lines letter
    for letter. Every `train` call's sizes and bytes equal the
    reference's accounting."""
    _small(monkeypatch, port, ManyClassDataset, tabular.SplitSpec)
    _small(monkeypatch, ref, JDataset, jtab.SplitSpec)
    calls = []
    for name in RESULT_FNS:
        if hasattr(port, name):
            fn = getattr(port, name)
            if name == "train":
                fn = functools.partial(fn, batch=BATCH)

            def record(*a, _fn=fn, _name=name, **kw):
                out = _fn(*a, **kw)
                calls.append((_name, a, kw, out))
                return out
            monkeypatch.setattr(port, name, record)
    got = []
    _call(port.main, got.append, port=True)
    left = _replay(monkeypatch, ref, [out for *_, out in calls])
    want = []
    _call(ref.main, want.append, port=False)
    assert not left
    assert got == want
    assert any("_check," in ln or "_info," in ln for ln in got)
    for name, args, kw, out in calls:
        if name != "train":
            continue
        sp = args[0]
        jspec = jtab.SplitSpec(**{f.name: getattr(sp, f.name)
                                  for f in dataclasses.fields(jtab.SplitSpec)})
        assert out["steps"] == kw["epochs"] * (args[1].n_train // BATCH)
        if sp.method == "l1":
            continue
        total = 0.0
        for _ in range(out["steps"]):
            total += jtab.wire_bytes(jspec, BATCH, training=True)
        assert out["train_bytes"] == total
        rel = 1.0 if sp.method == "none" else jwire.table2_row(
            sp.method, sp.cut_dim, k=sp.k, bits=sp.quant_bits)["fwd"]
        assert out["compressed_size_pct"] == 100.0 * rel


def _h(*key) -> float:
    return zlib.crc32(repr(key).encode()) / 2 ** 32


def _spec_key(sp):
    return tuple(getattr(sp, f) for f in ("method", "k", "alpha",
                                          "quant_bits", "l1_lam", "cut_dim",
                                          "n_classes"))


def _fake(salt):
    """Made-up section results, the same for both packages, that depend on
    `salt` so that each check comes out both ways over the salts."""
    def train(sp, ds, *, epochs, seed=0, record_every=0, **kw):
        key = (salt, _spec_key(sp), seed, epochs)
        steps = epochs * (ds.n_train // 128)
        trace = [(it, it * 1e3 * (1 + _h(key, "b")), 2 * _h(key, it),
                  _h(key, "a", it) * 0.3)
                 for it in range(record_every, steps + 1, record_every or 1)
                 ] if record_every else []
        test_acc, train_acc = _h(key, "test"), _h(key, "train")
        return {"test_acc": test_acc, "train_acc": train_acc,
                "gen_gap": train_acc - test_acc,
                "compressed_size_pct": 100 * _h(key, "size"),
                "train_bytes": 1e6 * _h(key, "bytes"), "trace": trace,
                "bottom": key}

    def selection_histogram(bottom, k, x):
        rng = np.random.RandomState(zlib.crc32(repr(bottom).encode()))
        return rng.randint(0, 2 + int(50 * _h(bottom)), 128) * \
            (rng.rand(128) > 0.1)

    def attack(bottom, view_fn, ds, *, epochs=8, **kw):
        return _h(bottom, "mse", epochs)

    def train_ef(sp, ds, *, epochs, seed=0, **kw):
        return _h(salt, _spec_key(sp), "ef")

    def run_fedtrain(spec, ds, *, n_clients, epochs, batch, seed, **kw):
        key = (salt, _spec_key(spec), tuple(sorted(set(kw) - {"device"})))
        steps = 3 + int(20 * _h(key, "steps"))
        up, down = 10 ** 5 + int(1e5 * _h(key, "up")), 10 ** 5
        return {"steps": steps, "mean_test_acc": _h(key, "acc"),
                "payload_bytes_up": up, "payload_bytes_down": down,
                "header_bytes": 17 * steps, "final_k": [spec.k, spec.k - 1],
                "wall_s": 10 * _h(key, "wall"),
                "losses": [[(s, 3 * _h(key, s)) for s in range(steps)]],
                "analytic_bytes_up": up * (1 + 0.1 * _h(key, "au")),
                "analytic_bytes_down": down * (1 + 0.1 * _h(key, "ad"))}

    return dict(train=train, selection_histogram=selection_histogram,
                attack=attack, train_ef=train_ef, run_fedtrain=run_fedtrain)


@pytest.mark.parametrize("section,ref,port", SECTIONS,
                         ids=[s[0] for s in SECTIONS])
def test_section_lines_and_checks_equal_reference_on_made_up_results(
        monkeypatch, section, ref, port):
    """Both scripts on the same made-up results for three salts: the same
    lines letter for letter, and together the checks come out both ways
    (where the section has a check)."""
    seen = set()
    for salt in range(3):
        lines = {}
        for mod, dataset_cls, split_spec in (
                (ref, JDataset, jtab.SplitSpec),
                (port, ManyClassDataset, tabular.SplitSpec)):
            _small(monkeypatch, mod, dataset_cls, split_spec)
            for name, fn in _fake(salt).items():
                if hasattr(mod, name):
                    monkeypatch.setattr(mod, name, fn)
            out = []
            _call(mod.main, out.append, port=mod is port)
            lines[mod] = out
        assert lines[port] == lines[ref]
        seen.update(ln.rsplit(",", 1)[1] for ln in lines[port]
                    if "_check," in ln)
    if section != "ef":
        assert seen == {"True", "False"}


def _drop_timing(lines):
    return [ln for ln in lines if not ln.startswith("kernel_bench,")]


def test_table2_lines_equal_reference():
    got, want = [], []
    assert table2_sizes.main(emit=got.append, device="cpu")
    r_table2.main(emit=want.append)
    assert _drop_timing(got) == _drop_timing(want)
    assert len(_drop_timing(got)) == 15
    assert sum(ln.startswith("kernel_bench,topk_bisect_256x1024,us_per_call,")
               for ln in got) == 1


@pytest.mark.parametrize("kind,k,bits", [
    ("dense", 0, 0), ("slice", 3, 0), ("sparse", 3, 0), ("mask", 3, 0),
    ("quant", 0, 4), ("sparse_quant", 7, 8)])
@pytest.mark.parametrize("d", [128, 600])
def test_payload_bits_per_instance_equals_reference(kind, k, bits, d):
    assert wire.payload_bits_per_instance(PayloadMeta(kind, d, k, bits)) == \
        jwire.payload_bits_per_instance(JMeta(kind, d, k, bits))


@pytest.mark.parametrize("method,kw", table2_sizes.CODECS,
                         ids=[m for m, _ in table2_sizes.CODECS])
@pytest.mark.parametrize("d", [128, 600])
def test_payload_bits_per_instance_equals_codec_fwd_bits(method, kw, d):
    """The three copies of the forward bit accounting agree: the wire's
    per-instance bits of the codec's encoded meta, the codec's own
    `fwd_bits` and the Table-2 row (which leaves out quant's 8 B range
    header)."""
    from repro_torch.core import compressors as C

    comp = C.make_compressor(method, **kw)
    meta, _ = table2_sizes.measured_nbytes(comp, torch.randn(4, d))
    bits = wire.payload_bits_per_instance(meta)
    assert bits == comp.fwd_bits(d)
    header = 64 if method == "quant" else 0
    assert bits == wire.table2_row(method, d, **kw)["fwd"] * d * 32 + header


def test_fig2_alpha0_run_equals_reference():
    """Deterministic at alpha 0: the same final w and loss."""
    jw, jloss, _ = r_fig2.run(alpha=0.0, steps=200)
    w, loss, traj = fig2_toy.run(alpha=0.0, steps=200, device="cpu")
    np.testing.assert_allclose(w, np.asarray(jw), atol=1e-6)
    assert abs(loss - jloss) <= 1e-6
    assert len(traj) == 2


def test_fig2_update_on_given_flips_equals_jax_grad():
    """200 steps with the flips drawn by numpy, the port's mask and
    autograd step against the reference's mask rule and `jax.grad`."""
    flips = np.random.RandomState(0).rand(200, 2, 1) < 0.3
    jgrad = jax.jit(jax.grad(r_fig2.loss_fn))
    jw = jnp.array([1.0, -0.1])
    w = torch.tensor([1.0, -0.1])
    for flip in flips:
        o = jnp.abs(jw * r_fig2.X)
        top = (o >= o.max(-1, keepdims=True)).astype(jnp.float32)
        jw = jw - 0.1 * jgrad(jw, jnp.where(flip, 1.0 - top, top))
        w = w - 0.1 * fig2_toy.grad(w, fig2_toy.flip_mask(
            w, torch.from_numpy(flip)))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6)


def test_fig2_full_run_holds_the_claims():
    lines = []
    fig2_toy.main(emit=lines.append, device="cpu")
    assert "fig2_toy,topk_stuck,True" in lines
    assert "fig2_toy,randtopk_escaped,True" in lines


def _ref_parties(spec, seed=0):
    jb, jt = jtab.init_parties(jax.random.key(seed), spec)
    np_b, np_t = (jax.tree.map(np.asarray, p) for p in (jb, jt))
    return (jb, jt), parties_from_jax(np_b, np_t, "cpu")


def test_fit_ef_equals_reference(monkeypatch):
    """One epoch of per-class error-feedback training from the
    reference's initial weights: the parameters within rtol 1e-5."""
    jspec = jtab.SplitSpec(in_dim=16, hidden=32, n_classes=10,
                           method="topk", k=3, lr=2e-3)
    spec = tabular.SplitSpec(in_dim=16, hidden=32, n_classes=10,
                             method="topk", k=3, lr=2e-3)
    jds, ds = JDataset(**SMALL), ManyClassDataset(**SMALL)
    seen = {}

    def capture(bottom, top, sp, x, y):
        seen["params"] = (bottom, top)
        return 0.0
    monkeypatch.setattr(jtab, "evaluate", capture)
    r_ef.train_ef(jspec, jds, epochs=1, seed=0)
    _, params = _ref_parties(jspec)
    bottom, top = error_feedback.fit_ef(spec, ds, epochs=1, seed=0,
                                        device="cpu", params=params)
    for jpart, part in zip(seen["params"], (bottom, top)):
        for name, a in jpart.items():
            np.testing.assert_allclose(part[name].numpy(), np.asarray(a),
                                       rtol=1e-5, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("view", ["dense", "topk"])
def test_attack_mse_equals_reference(view):
    """The inversion attack from the same bottom and inverter weights: the
    test MSE within rtol 1e-4."""
    jspec = jtab.SplitSpec(in_dim=16, hidden=32, n_classes=10)
    (jb, _), (bottom, _) = _ref_parties(jspec, seed=3)
    jds, ds = JDataset(**SMALL), ManyClassDataset(**SMALL)
    jinv = r_privacy._inverter_init(jax.random.key(0), 128, 16)
    inv = {k: torch.from_numpy(np.array(v)) for k, v in jinv.items()}
    if view == "dense":
        jview, pview = (lambda o: o), (lambda o: o)
    else:
        jview = lambda o: o * jsel.topk_mask(o, 3).astype(o.dtype)  # noqa
        pview = appendixB_privacy.topk_view
    want = r_privacy.attack(jb, jview, jds, epochs=1, seed=0)
    got = appendixB_privacy.attack(bottom, pview, ds, epochs=1, seed=0,
                                   inv=inv)
    assert got == pytest.approx(want, rel=1e-4)


def test_selection_histogram_and_entropy_equal_reference():
    jspec = jtab.SplitSpec(in_dim=16, hidden=32, n_classes=10)
    (jb, _), (bottom, _) = _ref_parties(jspec, seed=5)
    ds = ManyClassDataset(**SMALL)
    want = r_fig5.selection_histogram(jb, 3, ds.x_train)
    got = fig5_distribution.selection_histogram(bottom, 3, ds.x_train)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 3 * SMALL["n_train"]
    assert abs(fig5_distribution.norm_entropy(got)
               - r_fig5.norm_entropy(want)) <= 1e-6


def test_run_cpu_table2_fig2_exits_0(capsys):
    assert run.main(["--device", "cpu", "--only", "table2,fig2"]) == 0
    out = capsys.readouterr().out
    assert "## 0 failed checks" in out
    assert "table2_check,analytic_matches_measured,True" in out


def test_run_exits_1_on_a_failed_check(monkeypatch, capsys):
    monkeypatch.setattr(run, "_sections", lambda: {
        "table2": lambda emit, device: emit("table2_check,made_up,False")})
    assert run.main(["--device", "cpu", "--only", "table2"]) == 1
    out = capsys.readouterr().out
    assert "## 1 failed checks" in out
    assert "FAILED: table2_check,made_up,False" in out


@pytest.mark.parametrize("name", ["serve", "loadgen", "roofline", "wire",
                                  "nosuch"])
def test_run_refuses_sections_outside_the_experiments(capsys, name):
    assert run.main(["--device", "cpu", "--only", f"table2,{name}"]) == 2
    err = capsys.readouterr().err
    assert ("Queue 1 item 1" in err) == (name != "nosuch")


def test_run_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.main(["--only", "table2"])
