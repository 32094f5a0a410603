"""Port parity: federated split training over the wire
(`repro_torch.fedtrain`) against the port's two-party trainer
(`split.tabular.train`) and against the reference's `repro.fedtrain`, on
the CPU, plus the behaviour `tests/test_fedtrain.py` pins for the
reference: both parties count the same frames, measured bytes follow the
analytics, randtopk_mask trains like randtopk, async local steps and the
adaptive schedule.

Against the reference both packages start from the reference's initial
weights (converted) and see the same numpy batches; for the randomized
methods the test computes in JAX the draws the reference's client makes
from each step key (`key, sub = split(key)`, then `kb, kg = split(sub)`,
`binomial_nontop_count(kb, ...)`, `gumbel(kg, ...)`) and hands them to the
port by replacing its `selection.binomial_nontop_count` and
`selection.gumbel_noise`.

Tolerances: against `tabular.train` one device and one generator give the
same losses and weights bit for bit; against the reference losses within
rtol 1e-5, payload and framing bytes exact, test accuracy within two
samples (an argmax between two near-equal logits may flip)."""
import collections
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import selection as jsel
from repro.data.synthetic import ManyClassDataset as JDataset
from repro.fedtrain import run_fedtrain as jrun_fedtrain
from repro.fedtrain import schedule as jschedule
from repro.split import tabular as jtab
from repro_torch.core import compressors as C, selection, wire
from repro_torch.core.payload import to_host
from repro_torch.data.synthetic import ManyClassDataset
from repro_torch.fedtrain import (AsyncPolicy, KScheduler, ScheduleSpec,
                                  TrainingServer, run_fedtrain)
from repro_torch.fedtrain.schedule import ANNEAL_STAGES
from repro_torch.launch import fedtrain as cli
from repro_torch.models.convert import parties_from_jax
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime.transport import channel_pair
from repro_torch.split import tabular

D = 32
METHODS = ["none", "topk", "randtopk", "randtopk_mask", "size_reduction",
           "quant", "randtopk_quant", "l1"]
RANDOM = ("randtopk", "randtopk_mask", "randtopk_quant")


def _dataset(mod=None):
    return (mod or ManyClassDataset)(n_classes=10, in_dim=16, n_train=512,
                                     n_test=256, noise=0.3, seed=0)


def _spec(method="randtopk", mod=tabular, **kw):
    kw.setdefault("k", 3)
    return mod.SplitSpec(in_dim=16, hidden=32, cut_dim=D, n_classes=10,
                         method=method, **kw)


def _losses(res, cid=0):
    return np.asarray([loss for _, loss in res["losses"][cid]])


def _run(spec, **kw):
    kw.setdefault("n_clients", 1)
    kw.setdefault("epochs", 1)
    return run_fedtrain(spec, _dataset(), batch=64, seed=0, device="cpu",
                        **kw)


@pytest.mark.parametrize("method", METHODS)
def test_one_client_equals_tabular_train(method):
    """One client over real frames is `tabular.train`: same init, batch
    order and draw chain, so the same losses and weights bit for bit."""
    spec = _spec(method)
    tab = tabular.train(spec, _dataset(), epochs=2, batch=64, seed=0,
                        record_every=1, device="cpu")
    fed = _run(spec, epochs=2)
    assert fed["steps"] == tab["steps"] == 16
    np.testing.assert_array_equal(_losses(fed),
                                  [t[2] for t in tab["trace"]])
    for name, t in tab["bottom"].items():
        assert torch.equal(fed["bottoms"][0][name], t), name
    for name, t in tab["top"].items():
        assert torch.equal(fed["top"][name], t), name
    assert fed["mean_test_acc"] == tab["test_acc"]


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
                                         dtype=jnp.float32))
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


@pytest.mark.parametrize("method", METHODS)
def test_matches_reference_fedtrain(monkeypatch, method):
    """The port's `run_fedtrain` against the reference's from the same
    initial weights, batches and (for RandTopK) draws."""
    jspec, spec = _spec(method, jtab), _spec(method)
    want = jrun_fedtrain(jspec, _dataset(JDataset), n_clients=1, epochs=1,
                         batch=64, seed=0)
    jb, jt = jtab.init_parties(jax.random.key(0), jspec)
    b, t = parties_from_jax(*(jax.tree.map(np.asarray, p) for p in (jb, jt)),
                            "cpu")
    queue = None
    if method in RANDOM:
        queue = _inject(monkeypatch,
                        _reference_draws(spec, 0, want["steps"], 64))
    got = _run(spec, params=([b], t))
    assert got["steps"] == want["steps"] == 8
    assert not queue, "the port made fewer draws than the reference"
    np.testing.assert_allclose(_losses(got), _losses(want), rtol=1e-5)
    for key in ("payload_bytes_up", "payload_bytes_down", "header_bytes",
                "analytic_bytes_up", "analytic_bytes_down"):
        assert got[key] == want[key], key
    assert abs(got["mean_test_acc"] - want["mean_test_acc"]) <= 2 / 256


def test_mask_wire_trains_like_randtopk():
    """randtopk_mask == randtopk step for step: the mask encoding changes
    the frames (a packed support bitmask instead of packed indices), not
    the selection or the same-mask backward."""
    r_idx = _run(_spec("randtopk", k=7))
    r_msk = _run(_spec("randtopk_mask", k=7))
    np.testing.assert_array_equal(_losses(r_msk), _losses(r_idx))
    # 7 indices of 5 bits (35) against a 32-bit mask: the mask is smaller
    assert r_msk["payload_bytes_up"] < r_idx["payload_bytes_up"]


@pytest.mark.parametrize("method,kw", [
    ("randtopk", dict(k=3)), ("topk", dict(k=3)),
    ("size_reduction", dict(k=3)), ("quant", dict(quant_bits=4)),
    ("randtopk_quant", dict(k=3, quant_bits=4)), ("none", {}),
    ("randtopk_mask", dict(k=3)),
])
def test_measured_bytes_match_analytics(method, kw):
    r = _run(_spec(method, **kw))
    for direction in ("up", "down"):
        measured = r[f"payload_bytes_{direction}"]
        analytic = r[f"analytic_bytes_{direction}"]
        assert abs(measured - analytic) / analytic < 0.05, (
            direction, measured, analytic)


def test_both_parties_count_the_same_frames():
    r = _run(_spec(), n_clients=2)
    for cs, ss in zip(r["client_stats"], r["server_stats"]):
        for f in ("frames_up", "payload_bytes_up", "header_bytes_up",
                  "frames_down", "payload_bytes_down", "header_bytes_down",
                  "bytes_down"):
            assert cs[f] == ss[f], (f, cs, ss)
        assert cs["frames_up"] == cs["frames_down"] == r["steps"]


def test_async_policy_reduces_both_directions():
    sync = _run(_spec(), epochs=2)
    asy = _run(_spec(), epochs=2, policy=AsyncPolicy(local_steps=4))
    assert asy["steps"] == sync["steps"]
    assert asy["client_stats"][0]["frames_up"] == -(-sync["steps"] // 4)
    assert asy["payload_bytes_up"] * 3 < sync["payload_bytes_up"]
    assert asy["payload_bytes_down"] * 3 < sync["payload_bytes_down"]
    assert np.isfinite(asy["mean_test_acc"])


def test_async_policy_schedule():
    p = AsyncPolicy(local_steps=3, warmup_sync=2)
    assert [p.is_sync(s) for s in range(8)] == [
        True, True, True, False, False, True, False, False]


def test_scheduler_matches_reference():
    """Warmup, anneal and plateau drops: the port's KScheduler gives the
    reference's k sequence for the same losses."""
    kw = dict(k=8, d=64, warmup_steps=3, anneal_steps=6, k_min=2,
              drop=0.5, patience=2, min_rel_improve=0.5)
    ours = KScheduler(ScheduleSpec(**kw))
    ref = jschedule.KScheduler(jschedule.ScheduleSpec(**kw))
    ks = [ours.k_bits(s)[0] for s in range(12)]
    assert ks == [ref.k_bits(s)[0] for s in range(12)]
    assert ks[:3] == [64, 64, 64] and ks[8] == 8 and ks[-1] == 8
    assert len(set(ks[3:9])) <= ANNEAL_STAGES
    for loss in [1.0, 1.0, 1.0, 1.0, 1.0, 0.1, 1.0, 1.0]:
        ours.observe(loss)
        ref.observe(loss)
        assert ours.cur_k == ref.cur_k
    assert ours.cur_k == 2                      # floored at k_min
    assert {k: float(v) for k, v in ours.state().items()} == \
        {k: float(v) for k, v in ref.state().items()}


def test_adaptive_schedule_over_the_wire():
    """Per-step k changes need no server configuration: frames describe
    themselves, and the analytics follow the schedule."""
    sched = ScheduleSpec(k=6, d=D, warmup_steps=2, anneal_steps=4, k_min=3,
                         patience=3)
    r = _run(_spec(k=6), epochs=2, schedule=sched)
    ks = [k for _, k, _ in r["k_trace"][0]]
    assert ks[0] == D and ks[1] == D            # dense warmup frames
    assert all(a >= b for a, b in zip(ks, ks[1:]))
    assert ks[-1] <= 6
    assert abs(r["payload_bytes_up"] - r["analytic_bytes_up"]) \
        / r["analytic_bytes_up"] < 0.05
    assert r["final_k"][0] <= 6


def _server_and_frame():
    """A training server on the CPU with one attached channel, and one
    valid topk payload frame (session 0, seq 0)."""
    spec = _spec("topk")
    _, top = tabular.init_parties(torch.Generator().manual_seed(0), spec)
    srv = TrainingServer(spec, top, adamw_init(top), device="cpu",
                         max_batch=1, max_wait=0.0)
    srv.labels_for = lambda sid, seq: np.arange(4, dtype=np.int32)
    srv.expected_sessions = 1
    cep, sep = channel_pair()
    srv.attach(sep)
    x = torch.from_numpy(np.random.RandomState(0).rand(4, D).astype(
        np.float32))
    frame = wire.encode_payload_frame(0, 0, to_host(C.TopK(k=3).encode(x)))
    return srv, cep, frame


def test_training_server_rejects_malformed_frames():
    """The connection plumbing shared with the serving server
    (`FrameServerBase`): a frame that fails its CRC, and a frame of a kind
    the up direction never carries, each get an error frame naming the
    defect; the connection is retired, the server keeps running."""
    srv, cep, frame = _server_and_frame()
    bad = bytearray(frame)
    bad[-1] ^= 0xFF
    cep.send(bytes(bad))
    reply = cep.recv_frame(timeout=10)
    assert reply.kind == wire.FRAME_ERROR and srv.faults_detected == 1
    cep2, sep2 = channel_pair()
    srv.attach(sep2)
    cep2.send(wire.encode_token_frame(0, 0, [1]))
    reply = cep2.recv_frame(timeout=10)
    assert reply.kind == wire.FRAME_ERROR and "training" in reply.error_msg
    assert srv.faults_detected == 2 and not srv.errors
    srv.shutdown()


def test_training_server_reacks_a_replay_without_stepping():
    """Stop-and-wait dedup: a replayed frame is answered from the cached
    grad frame and the top optimizer does not step again."""
    srv, cep, frame = _server_and_frame()
    loop = threading.Thread(target=srv.train_loop, daemon=True)
    loop.start()
    cep.send(frame)
    first = cep.recv_frame(timeout=10)
    top = {k: v.clone() for k, v in srv.top.items()}
    cep.send(frame)
    again = cep.recv_frame(timeout=10)
    assert (again.kind, again.seq, again.loss) == (wire.FRAME_GRAD, 0,
                                                    first.loss)
    np.testing.assert_array_equal(again.payload.values, first.payload.values)
    assert srv.step_count == 1
    stats = srv.sessions[0].stats
    assert stats.duplicates == 1 and stats.frames_down == 2
    assert all(torch.equal(srv.top[k], top[k]) for k in top)
    cep.send(wire.encode_close_frame(0))
    loop.join(timeout=10)
    assert not loop.is_alive()


def test_cli_runs_on_cpu(capsys):
    res = cli.main(["--device", "cpu", "--clients", "2", "--epochs", "1",
                    "--train-n", "512", "--classes", "10", "--cut-dim", "32",
                    "--k", "4", "--local-steps", "2", "--schedule",
                    "adaptive"])
    out = capsys.readouterr().out
    assert "trained 2 clients" in out and "B analytic" in out
    assert res["steps"] == 2 and np.isfinite(res["mean_test_acc"])


def test_cli_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--clients", "1", "--epochs", "1", "--train-n", "256"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_fedtrain(_spec(), _dataset(), epochs=1)
