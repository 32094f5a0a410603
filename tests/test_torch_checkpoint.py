"""The port's checkpoint store (`repro_torch.checkpoint.store`), resume of
federated training from it, and per-class error feedback
(`repro_torch.core.error_feedback`) against the reference's, on the CPU.

Tolerances: a restored tree equals the saved one exactly (bf16 widens to
f32 exactly); a killed and resumed run equals the uninterrupted one in
losses, bytes and final weights bit for bit (one device, one generator
per client, whole-round flushes applied in session order);
`ef_topk_forward` equals the reference exactly."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import error_feedback as jef
from repro_torch.checkpoint import store
from repro_torch.core import error_feedback as ef
from repro_torch.data.synthetic import ManyClassDataset
from repro_torch.fedtrain import AsyncPolicy, ScheduleSpec, run_fedtrain
from repro_torch.split import tabular


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((3, 5), generator=g).to(torch.bfloat16),
                   "b": torch.randn((5,), generator=g)},
        "opt": {"step": torch.tensor(7, dtype=torch.int32)},
        "gen": g.get_state(),
        "counters": np.asarray([1, 2 ** 40], np.int64),
        "ema": np.float32(0.25),
        "sched": {},
    }


def test_round_trip_keeps_dtype_shape_and_generator(tmp_path):
    tree = _tree()
    path = store.save(str(tmp_path), 12, tree)
    assert os.path.basename(path) == "step_00000012.npz"
    assert os.listdir(tmp_path) == ["step_00000012.npz"]   # no temp file
    with np.load(path) as data:
        assert set(data) == {"params/w", "params/b", "opt/step", "gen",
                             "counters", "ema"}
        assert data["params/w"].dtype == np.float32         # bf16 widened
    like = _tree(seed=1)
    got = store.restore(str(tmp_path), 12, like)
    assert got["params"]["w"].dtype == torch.bfloat16
    for a, b in ((got["params"]["w"], tree["params"]["w"]),
                 (got["params"]["b"], tree["params"]["b"]),
                 (got["opt"]["step"], tree["opt"]["step"]),
                 (got["gen"], tree["gen"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got["counters"].tolist() == [1, 2 ** 40]
    assert float(got["ema"]) == 0.25 and got["sched"] == {}
    # the restored generator state continues the saved generator's draws
    g0, g1 = torch.Generator(), torch.Generator()
    g0.set_state(tree["gen"])
    g1.set_state(got["gen"])
    assert torch.equal(torch.rand(4, generator=g0),
                       torch.rand(4, generator=g1))


def test_restore_raises_on_a_shape_mismatch(tmp_path):
    store.save(str(tmp_path), 1, {"w": torch.zeros((2, 3))})
    with pytest.raises(ValueError, match="shape"):
        store.restore(str(tmp_path), 1, {"w": torch.zeros((3, 2))})


def test_latest_step(tmp_path):
    assert store.latest_step(str(tmp_path / "missing")) == -1
    for step in (4, 20, 8):
        store.save(str(tmp_path), step, {"x": np.zeros(1)})
    (tmp_path / "notes.txt").write_text("not a checkpoint")
    assert store.latest_step(str(tmp_path)) == 20


def _dataset():
    return ManyClassDataset(n_classes=10, in_dim=16, n_train=512,
                            n_test=256, noise=0.3, seed=0)


def _spec(method="randtopk", **kw):
    return tabular.SplitSpec(in_dim=16, hidden=32, cut_dim=32, n_classes=10,
                             method=method, k=3, **kw)


def _assert_resumed_equals_full(full, resumed, start):
    for cid in range(full["n_clients"]):
        f = [(s, loss) for s, loss in full["losses"][cid] if s >= start]
        assert resumed["losses"][cid] == f
    for key in ("payload_bytes_up", "payload_bytes_down", "header_bytes",
                "analytic_bytes_up", "analytic_bytes_down", "final_k"):
        assert resumed[key] == full[key], key
    for a, b in zip(full["bottoms"] + [full["top"]],
                    resumed["bottoms"] + [resumed["top"]]):
        for name in a:
            assert torch.equal(a[name], b[name]), name
    assert resumed["mean_test_acc"] == full["mean_test_acc"]


@pytest.mark.parametrize("method,kw", [
    ("randtopk", dict(n_clients=1)),
    ("topk", dict(n_clients=1, ef=True)),
    ("randtopk_mask", dict(n_clients=2, epochs=4,
                           policy=AsyncPolicy(local_steps=2),
                           schedule=ScheduleSpec(k=3, d=32, anneal_steps=4,
                                                 k0=8, k_min=2, patience=2),
                           max_wait=5.0)),
])
def test_resume_equals_uninterrupted_run(tmp_path, method, kw):
    """Kill a run at step 8, resume it from the store: the same losses,
    bytes and final weights as the run that was never stopped (with two
    clients, whole-round flushes make the top updates' order fixed)."""
    run = dict(epochs=2, batch=64, seed=0, device="cpu")
    run.update(kw)
    spec = _spec(method)
    full = run_fedtrain(spec, _dataset(), **run)
    ckpt = str(tmp_path / "fed")
    killed = run_fedtrain(spec, _dataset(), ckpt_dir=ckpt, ckpt_every=4,
                          stop_after_steps=8, **run)
    assert killed["steps"] == 8 and store.latest_step(ckpt) == 8
    resumed = run_fedtrain(spec, _dataset(), ckpt_dir=ckpt, ckpt_every=4,
                           **run)
    assert resumed["losses"][0][0][0] == 8      # picked up where killed
    _assert_resumed_equals_full(full, resumed, 8)


def test_ef_topk_forward_matches_reference():
    """Three steps with the residual memory carried: view, mask and memory
    equal the reference's."""
    rng = np.random.RandomState(0)
    n_slots, d, k = 5, 24, 4
    err = np.zeros((n_slots, d), np.float32)
    jerr = jnp.asarray(err)
    terr = torch.from_numpy(err)
    for _ in range(3):
        o = rng.randn(16, d).astype(np.float32)
        y = rng.randint(0, n_slots - 1, size=16).astype(np.int32)
        jv, jm, jerr = jef.ef_topk_forward(jnp.asarray(o), jerr,
                                           jnp.asarray(y), k, n_slots)
        tv, tm, terr = ef.ef_topk_forward(torch.from_numpy(o), terr,
                                          torch.from_numpy(y), k, n_slots)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(terr.numpy(), np.asarray(jerr))
        assert (tm.sum(-1) == k).all()
    # the last slot never had a sample: its memory stays zero
    assert not terr[n_slots - 1].any()
