"""`python -m repro_torch.launch.train --ckpt-dir --ckpt-every` on the CPU,
at SMOKE, for a dense model (yi-6b) and a mixture of experts
(granite-moe-1b-a400m).

A checkpoint holds the params, the optimizer and the state of the
generator that draws each step's RandTopK noise. A run stopped at step 3
and resumed to 6 equals the uninterrupted 6-step run bit for bit, in its
printed losses and its final params. The params and optimizer files hold
the keys, shapes and dtypes of the reference's `repro.launch.train`
checkpoints, under the same names (`step_%08d.npz`, `opt/`).
"""
import contextlib
import io
import os
import re

import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro_torch.launch import train
from repro_torch.optim.adamw import tree_leaves

ARCHS = ["yi-6b", "granite-moe-1b-a400m"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: a CPU reduction split over threads need not
    add in the same order twice, and the resume is compared bit for bit;
    restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _main(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        params = train.main(argv)
    return params, buf.getvalue()


def _losses(out):
    return re.findall(r"step +(\d+) loss=([0-9.]+) ce=([0-9.]+) "
                      r"aux=([0-9.]+) gnorm=([0-9.]+)", out)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_restores_checkpoint(tmp_path, arch):
    """The reference's restore test: a run to step 10 saves there; a
    later run to 12 resumes from it."""
    ck = str(tmp_path / "ck")
    base = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "4",
            "--seq", "32", "--ckpt-dir", ck]
    _, first = _main(base + ["--steps", "10", "--ckpt-every", "10"])
    assert "restored" not in first
    _, out = _main(base + ["--steps", "12", "--ckpt-every", "100"])
    assert "restored step 10" in out
    assert [s for s, *_ in _losses(out)] == ["10", "11"]


@pytest.mark.parametrize("split", ["randtopk", "quant"])
@pytest.mark.parametrize("arch", ARCHS)
def test_stopped_and_resumed_equals_uninterrupted(tmp_path, arch, split):
    base = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--split", split, "--k", "8", "--log-every", "1"]
    full, out_full = _main(base + ["--steps", "6"])
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
    _, out_a = _main(base + ["--steps", "3"] + ck)
    resumed, out_b = _main(base + ["--steps", "6"] + ck)
    assert "restored step 3" in out_b
    assert len(_losses(out_full)) == 6
    assert _losses(out_a) + _losses(out_b) == _losses(out_full)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(resumed),
                                                 tree_leaves(full)))


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_files_are_in_the_references_layout(tmp_path, arch):
    ref, ours = tmp_path / "ref", tmp_path / "ours"
    argv = ["--arch", arch, "--smoke", "--steps", "2", "--batch", "2",
            "--seq", "16", "--ckpt-every", "1", "--split", "randtopk"]
    with contextlib.redirect_stdout(io.StringIO()):
        jtrain.main(argv + ["--ckpt-dir", str(ref)])
        train.main(argv + ["--device", "cpu", "--ckpt-dir", str(ours)])
    steps = ["step_00000001.npz", "step_00000002.npz"]
    assert sorted(os.listdir(ours)) == ["opt", "rng"] + steps
    assert sorted(os.listdir(ref)) == ["opt"] + steps
    assert sorted(os.listdir(ours / "rng")) == steps
    for sub in ("", "opt"):
        want = np.load(ref / sub / steps[-1])
        got = np.load(ours / sub / steps[-1])
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            assert (got[key].shape, got[key].dtype) == \
                (want[key].shape, want[key].dtype), key
    assert int(np.load(ours / "opt" / steps[-1])["step"]) == 2
