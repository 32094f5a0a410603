"""The load generator's launches, on the CPU with a fake library in place
of the built kernels (as `test_torch_codec_launch.py` does): when the
backend resolves to the kernels, the client makes ONE `encode_sections`
launch per served token on every QoS rung (sparse and sparse_quant, each
launch with its rung's k and bits), the server ONE `decode_to_slots`
launch per meta group of a flush, mixed-meta flushes included, and no
launch or call comes from the plain versions. The fake launches write
nothing, so only the counts and arguments are checked here; the chip
smoke test holds the real kernels' reports to the plain versions'.
"""
from __future__ import annotations

import collections

import pytest
import torch

from repro_torch import configs
from repro_torch.core.payload import KINDS
from repro_torch.kernels import _lib
from repro_torch.kernels.decode import ops as dec_ops
from repro_torch.kernels.decode import ref as dec_ref
from repro_torch.kernels.encode import ref as enc_ref
from repro_torch.models.config import SplitConfig
from repro_torch.runtime import loadgen as lg
from repro_torch.runtime.qos import QoSSpec
from repro_torch.split import protocol

QOS = QoSSpec(k=16, d=256, bits=8, bits_floor=4, k_floor=4, high_depth=6,
              low_depth=2, deadline_s=0.04, patience=16, cooldown=1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's loops run thousands of tiny CPU ops: one intra-op thread
    each, so test processes running side by side do not oversubscribe the
    cores (each op then waits on descheduled threads); restored after the
    module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _FakeFn:
    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


class _FakeLib:
    def __init__(self):
        for name in _lib.SIGNATURES:
            setattr(self, name, _FakeFn())


def _plain(*args, **kwargs):
    raise AssertionError("a plain version ran on the kernel path")


@pytest.fixture
def on_card(monkeypatch):
    """Every wrapper resolves to its kernel (the fake library), CPU tensors
    and all, and the plain versions must not run."""
    lib = _FakeLib()
    monkeypatch.setattr(_lib, "_LIB", None)
    monkeypatch.setattr(_lib, "_FNS", {})
    monkeypatch.setattr(_lib, "_load", lambda: lib)
    monkeypatch.setattr(_lib, "stream_handle", lambda t: 0)

    def cuda(backend, t):
        return "cuda" if (backend or "auto") != "torch" else "torch"

    monkeypatch.setattr(_lib, "resolve_backend", cuda)
    monkeypatch.setattr(protocol, "resolve_backend", cuda)
    monkeypatch.setattr(dec_ops, "_slot_sig", lambda t: None if t is None
                        else (t.shape, t.dtype, True, t.is_contiguous()))
    monkeypatch.setattr(enc_ref, "encode_sections", _plain)
    monkeypatch.setattr(dec_ref, "decode_to_slots", _plain)
    _lib.reset_launch_counts()
    yield lib
    _lib.reset_launch_counts()


def _config(qos=None, rate=12.0, duration_s=2.5):
    fleet = ("randtopk_quant:k=16,bits=8",) if qos else ("randtopk:k=16",)
    return lg.LoadGenConfig(
        seed=3, duration_s=duration_s,
        arrivals=lg.ArrivalSpec(process="mmpp", rate=rate,
                                burst_rate=2 * rate),
        fleet=lg.FleetSpec(compressors=fleet, prompt_len=(2, 3), gen=(3, 5),
                           bandwidth_Bps=400_000.0),
        service=lg.ServiceModel(1e-3, 1e-4, 3e-5), qos=qos, capacity=16,
        max_batch=8, max_wait=0.004, admission_depth=24)


def _buckets(max_batch):
    return len({1 << i for i in range(max_batch.bit_length())
                if (1 << i) <= max_batch} | {max_batch})


@pytest.mark.parametrize("qos", [None, QOS], ids=["static", "qos"])
def test_one_encode_per_token_and_one_decode_per_meta_group(on_card, qos):
    cfg = configs.get("yi-6b", smoke=True).with_(
        split=SplitConfig(cut_layer=1, compressor="randtopk", k=16))
    lgc = _config(qos, rate=40.0 if qos else 12.0)
    rep = lg.run_loadgen(cfg, lgc, device="cpu")
    counts = {n: c for n, c in _lib.launch_counts().items() if c}
    assert set(counts) == {"encode_sections", "decode_to_slots"}

    # the client: one fused encode per served token, at its rung's (k,
    # bits), plus one warm-up step per spec the scenario can reach
    specs = (len(qos.ladder()) if qos else 1)
    sent = collections.Counter(tuple(kb) for kbs in
                               rep["trace"]["k_bits"].values()
                               for kb in kbs)
    assert counts["encode_sections"] == sum(sent.values()) + specs
    kind = KINDS.index("sparse_quant" if qos else "sparse")
    by_rung = collections.Counter(
        (args[6], args[7]) for args in on_card.encode_sections.calls)
    assert all(args[5] == kind and args[8] == 1      # select in the launch
               for args in on_card.encode_sections.calls)
    for (k, bits), n in sent.items():
        assert by_rung[(k, bits)] == n + 1
    if qos:
        assert set(sent) == set(qos.ladder())       # every rung served

    # the server: one flush decode per (flush, meta) group, plus the warm
    # step's two per flush bucket and spec
    groups = rep["served"]["decode_groups"]
    warm = 2 * _buckets(lgc.max_batch) * specs
    assert counts["decode_to_slots"] == sum(groups.values()) + warm
    # one group per single-meta flush, two or more per mixed-meta flush
    mixed = rep["served"]["mixed_meta_flushes"]
    assert sum(groups.values()) - rep["flushes"] >= mixed
    assert (mixed > 0) == (qos is not None)
    if not qos:
        assert groups == {"sparse": rep["flushes"]}


def test_plain_backend_launches_nothing():
    """`split.backend="torch"` runs the plain versions: no launch."""
    _lib.reset_launch_counts()
    cfg = configs.get("yi-6b", smoke=True).with_(
        split=SplitConfig(cut_layer=1, compressor="randtopk", k=16,
                          backend="torch"))

    rep = lg.run_loadgen(cfg, _config(duration_s=0.5), device="cpu")
    assert rep["tokens_out"] > 0
    assert not any(_lib.launch_counts().values())
