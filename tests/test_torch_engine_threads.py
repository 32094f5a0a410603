"""The engines leave no server reader thread behind
(`runtime.engine.run_streaming`, `fedtrain.engine.run_fedtrain`).

Each client's CLOSE frame is dropped on its way up, so the server's reader
of that connection would wait for it for good: the engines' `shutdown`
backstop must stop it, and the engine joins every reader before it
returns. A daemon reader still inside torch when the interpreter exits
aborts it ("terminate called without an active exception").
"""
from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

import repro_torch.configs as configs
from repro_torch.core import wire
from repro_torch.data.synthetic import ManyClassDataset
from repro_torch.fedtrain import run_fedtrain
from repro_torch.models.config import SplitConfig
from repro_torch.runtime import engine
from repro_torch.runtime.server import FrameServerBase
from repro_torch.runtime.transport import Endpoint
from repro_torch.split import tabular


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _NoClose(Endpoint):
    """A client end whose CLOSE frames never leave it."""

    def __init__(self, inner: Endpoint):
        super().__init__(inner._out, inner._in)

    def send(self, frame_bytes: bytes) -> int:
        reader = wire.FrameReader()
        reader.feed(frame_bytes)
        if any(f.kind == wire.FRAME_CLOSE for f in reader.frames()):
            return len(frame_bytes)
        return super().send(frame_bytes)


@pytest.fixture
def readers(monkeypatch):
    """Every reader thread the servers start during the test."""
    started = []
    attach = FrameServerBase.attach

    def recorded(self, endpoint):
        started.append(attach(self, endpoint))
        return started[-1]

    monkeypatch.setattr(FrameServerBase, "attach", recorded)
    return started


def _serve():
    cfg = configs.get("qwen3-8b", smoke=True).with_(split=SplitConfig(
        cut_layer=1, compressor="randtopk", k=16, alpha=0.1))
    res = engine.run_streaming(cfg, n_clients=2, prompt_len=2, gen=3,
                               max_batch=2, device="cpu",
                               wrap_endpoint=lambda cid, ep: _NoClose(ep))
    assert res["tokens"].shape == (2, 3)


def _fedtrain():
    spec = tabular.SplitSpec(in_dim=16, hidden=32, cut_dim=32, n_classes=10,
                             method="randtopk", k=3)
    data = ManyClassDataset(n_classes=10, in_dim=16, n_train=256,
                            n_test=128, noise=0.3, seed=0)
    res = run_fedtrain(spec, data, n_clients=2, epochs=1, batch=64, seed=0,
                       device="cpu",
                       wrap_endpoint=lambda cid, ep: _NoClose(ep))
    assert np.isfinite([loss for _, loss in res["losses"][0]]).all()


@pytest.mark.parametrize("run", [_serve, _fedtrain],
                         ids=["run_streaming", "run_fedtrain"])
def test_no_reader_thread_outlives_the_run(readers, run):
    run()
    assert len(readers) == 2
    alive = set(threading.enumerate())
    assert not [t for t in readers if t in alive]
