"""The port's trace smoke (`repro_torch.testing.trace_smoke`) against the
reference's gate (`scripts/trace_smoke.py`), on the CPU.

The module exits 0 with `--device cpu`; its trace, on weights converted
from the reference's `init_model(jax.random.key(0), cfg)`, is
byte-identical to the reference's `run_loadgen` trace of the same
scenario (the reference's `_scenario`, loaded from the script by path),
and its checks report a trace with a lifecycle span taken out.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import transformer as jtr
from repro.models.config import SplitConfig as JSplit
from repro.runtime.loadgen import run_loadgen as jrun_loadgen
from repro.testing import FaultInjector as JFaultInjector
from repro.testing import FaultPlan as JFaultPlan
from repro_torch.models.convert import params_from_jax
from repro_torch.obs.trace import LIFECYCLE_SPANS
from repro_torch.testing import trace_smoke

SCRIPT = pathlib.Path(__file__).resolve().parents[1] / "scripts" / \
    "trace_smoke.py"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_scenario():
    spec = importlib.util.spec_from_file_location("ref_trace_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._scenario()


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    jcfg = jconfigs.get("qwen3-8b", smoke=True).with_(
        split=JSplit(cut_layer=1, compressor="randtopk", k=16))
    jp = jtr.init_model(jax.random.key(0), jcfg)
    cfg = trace_smoke.model_config()
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    path = tmp_path_factory.mktemp("ref") / "ref.json"
    jrun_loadgen(jcfg, _reference_scenario(), params=jp,
                 wrap_endpoint=JFaultInjector(JFaultPlan(
                     seed=11, corrupt=0.04, drop=0.05, duplicate=0.04,
                     reorder=0.03, max_faults=40)), trace_path=path)
    problems, got = trace_smoke.run(params=params, device="cpu")
    return {"problems": problems, "got": got, "ref": path.read_bytes()}


def test_trace_smoke_exits_zero_on_the_cpu(capsys):
    assert trace_smoke.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "two runs byte-identical=True" in out
    assert "trace_smoke: OK" in out


def test_trace_equals_the_reference(traces):
    assert traces["problems"] == []
    assert traces["got"] == traces["ref"]


@pytest.mark.parametrize("span", LIFECYCLE_SPANS)
def test_a_missing_lifecycle_span_is_reported(traces, span):
    obj = json.loads(traces["got"])
    assert trace_smoke.check_trace(obj) == []
    obj["traceEvents"] = [e for e in obj["traceEvents"]
                          if e["name"] != span]
    problems = trace_smoke.check_trace(obj)
    assert any(span in p for p in problems), problems
