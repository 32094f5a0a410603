"""Port parity of federated training under faults: the reference's
fedtrain chaos runs (`tests/test_faults.py`) against the port's
`run_fedtrain`, at the same spec, fault plans and ARQ settings, on the CPU.

Under seeded chaos (corrupt, truncate, drop, duplicate, reorder, re-chunk)
the clients retransmit and reconnect, the server re-acks replays from its
cache without stepping, and the run trains the clean run's weights: losses,
accuracy and final weights bit for bit, analytic bytes equal, measured
bytes no fewer. A replay resends the encoded bytes and never encodes
again, so with the reference's RandTopK draws handed in as data the chaos
run consumes exactly the clean run's draws and matches the reference's
clean run within rtol 1e-5.
"""
import collections

import jax
import numpy as np
import pytest
import torch

from repro.core import selection as jsel
from repro.data.synthetic import ManyClassDataset as JDataset
from repro.fedtrain import run_fedtrain as jrun_fedtrain
from repro.split import tabular as jtab
from repro_torch.core import selection
from repro_torch.data.synthetic import ManyClassDataset
from repro_torch.fedtrain import run_fedtrain
from repro_torch.models.convert import parties_from_jax
from repro_torch.split import protocol, tabular
from repro_torch.testing import DESTRUCTIVE_FAULTS, FaultInjector, FaultPlan

CHAOS_PLAN = dict(corrupt=0.06, truncate=0.03, drop=0.05, duplicate=0.05,
                  reorder=0.03, rechunk=0.15, max_faults=30)
HEAVY_PLAN = dict(corrupt=0.25, truncate=0.08, drop=0.1, duplicate=0.1,
                  reorder=0.05, rechunk=0.2, max_faults=60)
ARQ = dict(retry_timeout=0.3, max_retries=40)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread each, so test processes running side by side do
    not oversubscribe the cores; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dataset(mod=None):
    return (mod or ManyClassDataset)(n_classes=10, in_dim=16, n_train=512,
                                     n_test=256, noise=0.3, seed=0)


def _spec(method="randtopk", mod=tabular, k=3):
    return mod.SplitSpec(in_dim=16, hidden=32, cut_dim=32, n_classes=10,
                         method=method, k=k)


def _run(spec=None, **kw):
    kw.setdefault("n_clients", 1)
    return run_fedtrain(spec or _spec(), _dataset(), epochs=1, batch=64,
                        seed=0, device="cpu", **kw)


def _losses(res, cid=0):
    return np.asarray([loss for _, loss in res["losses"][cid]])


def _same_weights(a, b) -> bool:
    return all(torch.equal(x[n], y[n])
               for x, y in zip(a["bottoms"] + [a["top"]],
                               b["bottoms"] + [b["top"]]) for n in x)


def test_fedtrain_survives_chaos_with_identical_losses():
    clean = _run()
    assert all(v == 0 for v in clean["fault_counters"].values())

    inj = FaultInjector(FaultPlan(seed=7, **CHAOS_PLAN))
    chaos = _run(wrap_endpoint=inj, **ARQ)
    injected = inj.injected()
    fc = chaos["fault_counters"]
    assert sum(injected[f] for f in DESTRUCTIVE_FAULTS) > 0
    assert fc["replays"] + fc["duplicates"] + fc["reconnects"] > 0
    # replays were deduplicated: the top optimizer never stepped twice and
    # no corrupt frame was decoded
    np.testing.assert_array_equal(_losses(chaos), _losses(clean))
    assert chaos["mean_test_acc"] == clean["mean_test_acc"]
    assert _same_weights(chaos, clean)
    # the analytics count logical steps; measured bytes only grow
    assert chaos["analytic_bytes_up"] == clean["analytic_bytes_up"]
    assert chaos["payload_bytes_up"] >= clean["payload_bytes_up"]


@pytest.mark.slow
def test_fedtrain_survives_corrupt_first_frame_heavy_chaos():
    """A corrupt first frame retires the connection before the server
    made the session; the loop must stay open for the reconnect
    (`expected_sessions`), or the run starves at step 0. A quarter of the
    chunks corrupt makes that path near certain."""
    clean = _run()
    inj = FaultInjector(FaultPlan(seed=3, **HEAVY_PLAN))
    chaos = _run(wrap_endpoint=inj, retry_timeout=0.2, max_retries=60)
    assert chaos["fault_counters"]["reconnects"] > 0
    np.testing.assert_array_equal(_losses(chaos), _losses(clean))
    assert _same_weights(chaos, clean)


def test_fedtrain_chaos_multi_client_completes():
    """N > 1 under chaos: every session resumes and finishes its steps
    (arrival order across clients may differ, so no bit parity)."""
    inj = FaultInjector(FaultPlan(seed=21, **CHAOS_PLAN))
    r = _run(n_clients=2, wrap_endpoint=inj, **ARQ)
    assert r["steps"] == 4
    assert [len(x) for x in r["losses"]] == [4, 4]
    assert [[s for s, _ in x] for x in r["losses"]] == [[0, 1, 2, 3]] * 2
    assert np.isfinite(r["mean_test_acc"])


def test_replay_never_encodes_again(monkeypatch):
    """One encode per logical step, whatever the retransmits: a replay
    resends the frame's bytes (on the card: the randtopk_mask and fused
    encode launches equal the logical steps)."""
    calls = collections.Counter()
    encode = protocol.client_encode_device

    def counting(*a, **kw):
        calls["encode"] += 1
        return encode(*a, **kw)

    monkeypatch.setattr(protocol, "client_encode_device", counting)
    inj = FaultInjector(FaultPlan(seed=7, **CHAOS_PLAN))
    r = _run(wrap_endpoint=inj, **ARQ)
    assert r["fault_counters"]["replays"] > 0
    assert calls["encode"] == r["steps"] == 8
    assert r["client_stats"][0]["frames_up"] > r["steps"]


def test_resume_under_chaos_equals_the_clean_run(tmp_path):
    """Checkpoints at the barrier hold no ARQ state: stopped at step 4
    and resumed, each under its own chaos, equals the uninterrupted clean
    run."""
    clean = _run()
    kw = dict(ckpt_dir=str(tmp_path), ckpt_every=2, **ARQ)
    killed = _run(wrap_endpoint=FaultInjector(FaultPlan(seed=7,
                                                        **CHAOS_PLAN)),
                  stop_after_steps=4, **kw)
    resumed = _run(wrap_endpoint=FaultInjector(FaultPlan(seed=11,
                                                         **CHAOS_PLAN)),
                   **kw)
    assert killed["steps"] == 4 and resumed["losses"][0][0][0] == 4
    assert killed["losses"][0] + resumed["losses"][0] == clean["losses"][0]
    assert _same_weights(resumed, clean)


def test_spent_retries_fail_the_run():
    """A link that drops everything spends the retries, and the run
    raises: no fault is hidden."""
    inj = FaultInjector(FaultPlan(seed=0, drop=1.0, max_faults=10_000))
    with pytest.raises(RuntimeError, match="training clients failed"):
        _run(wrap_endpoint=inj, retry_timeout=0.02, max_retries=3,
             reply_timeout=5.0)


def _reference_draws(spec, seed, n_steps, batch):
    """The draws the reference's client makes at each step, in order."""
    key = jax.random.key(seed)
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        kb, kg = jax.random.split(sub)
        m = np.asarray(jsel.binomial_nontop_count(kb, spec.alpha, spec.k,
                                                  spec.cut_dim, (batch,)))
        g = np.asarray(jax.random.gumbel(kg, (batch, spec.cut_dim),
                                         dtype=jax.numpy.float32))
        out.append((m, g))
    return out


def _inject(monkeypatch, draws):
    queue = collections.deque(draws)
    cur = {}

    def count(*a, **kw):
        cur["m"], cur["g"] = queue.popleft()
        return torch.from_numpy(cur["m"].copy())

    monkeypatch.setattr(selection, "binomial_nontop_count", count)
    monkeypatch.setattr(selection, "gumbel_noise",
                        lambda *a, **kw: torch.from_numpy(cur["g"].copy()))
    return queue


@pytest.mark.parametrize("method", ["randtopk", "randtopk_mask", "topk"])
def test_chaos_run_matches_the_references_clean_run(monkeypatch, method):
    """From the reference's initial weights (converted) and with its draws
    handed in, the port's chaos run gives the reference's clean losses
    (rtol 1e-5) and bytes, and consumes exactly its draws."""
    jspec, spec = _spec(method, jtab), _spec(method)
    want = jrun_fedtrain(jspec, _dataset(JDataset), n_clients=1, epochs=1,
                         batch=64, seed=0)
    jb, jt = jtab.init_parties(jax.random.key(0), jspec)
    b, t = parties_from_jax(*(jax.tree.map(np.asarray, p) for p in (jb, jt)),
                            "cpu")
    queue = None
    if method != "topk":
        queue = _inject(monkeypatch,
                        _reference_draws(spec, 0, want["steps"], 64))
    inj = FaultInjector(FaultPlan(seed=7, **CHAOS_PLAN))
    got = _run(spec, params=([b], t), wrap_endpoint=inj, **ARQ)
    assert sum(inj.injected()[f] for f in DESTRUCTIVE_FAULTS) > 0
    assert got["steps"] == want["steps"] == 8
    assert not queue, "the port made fewer draws than the reference"
    np.testing.assert_allclose(_losses(got), _losses(want), rtol=1e-5)
    for key in ("analytic_bytes_up", "analytic_bytes_down"):
        assert got[key] == want[key], key
    assert got["payload_bytes_up"] >= want["payload_bytes_up"]
    assert abs(got["mean_test_acc"] - want["mean_test_acc"]) <= 2 / 256
