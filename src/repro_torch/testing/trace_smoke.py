"""Trace smoke: the observability layer's gate (the port's
`scripts/trace_smoke.py`).

Runs one short seeded open-loop loadgen scenario (virtual clock, chaos
injected) twice with tracing on, inside a temporary directory (no file
survives, pass or fail), and checks the telemetry contract:

  1. the exported file is schema-valid Chrome-trace-event JSON
     (`obs.export.validate_chrome_trace`) whose spans form a laminar
     family per track (`check_span_nesting`);
  2. all seven frame-lifecycle spans (`obs.trace.LIFECYCLE_SPANS`) and the
     QoS, ARQ and admission instants are present;
  3. the two same-seed runs wrote byte-identical files, the determinism
     the virtual-clock tracer promises.

The reference's fourth check reads the tracing-overhead gate from
`BENCH_serve.json`, its serving benchmark's output; it waits for the
port's benchmark (ROADMAP item 1).

    python -m repro_torch.testing.trace_smoke              # on the card
    PYTHONPATH=src python -m repro_torch.testing.trace_smoke --device cpu
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile

import torch

from repro_torch import configs
from repro_torch.models import transformer
from repro_torch.models.config import SplitConfig
from repro_torch.obs.export import check_span_nesting, validate_chrome_trace
from repro_torch.obs.trace import (EVT_ADMISSION_REJECT, EVT_ARQ_RETRANSMIT,
                                   EVT_QOS_TRANSITION, LIFECYCLE_SPANS)
from repro_torch.runtime.engine import resolve_device
from repro_torch.runtime.loadgen import (ArrivalSpec, FleetSpec,
                                         LoadGenConfig, ServiceModel,
                                         SLOSpec, run_loadgen)
from repro_torch.runtime.qos import QoSSpec
from repro_torch.testing.faults import FaultInjector, FaultPlan

#: every instant class the scenario must surface: admission pressure
#: (tight capacity under an MMPP burst), ARQ recovery (injected drops),
#: and QoS rung moves (latency pushed past the controller's deadline)
REQUIRED_INSTANTS = (EVT_ADMISSION_REJECT, EVT_ARQ_RETRANSMIT,
                     EVT_QOS_TRANSITION)


def scenario() -> LoadGenConfig:
    qos = QoSSpec(k=16, d=64, k_floor=4, high_depth=4, low_depth=1,
                  deadline_s=0.02, patience=4, cooldown=1)
    return LoadGenConfig(
        seed=11, duration_s=2.5,
        arrivals=ArrivalSpec(process="mmpp", rate=14.0, burst_rate=28.0,
                             mean_calm_s=1.0, mean_burst_s=1.0),
        fleet=FleetSpec(compressors=("randtopk:k=16",), prompt_len=(2, 3),
                        gen=(3, 5), bandwidth_Bps=400_000.0),
        service=ServiceModel(flush_overhead_s=2e-3, per_row_s=2e-4,
                             per_byte_s=3e-5),
        slo=SLOSpec(p99_ms=250.0, max_reject_frac=1.0),
        qos=qos, capacity=4, max_batch=4, max_wait=0.004,
        admission_depth=6, retry_timeout=0.05, max_retries=64)


def fault_plan() -> FaultPlan:
    return FaultPlan(seed=11, corrupt=0.04, drop=0.05, duplicate=0.04,
                     reorder=0.03, max_faults=40)


def model_config():
    return configs.get("qwen3-8b", smoke=True).with_(
        split=SplitConfig(cut_layer=1, compressor="randtopk", k=16))


def check_trace(obj) -> list:
    """Checks 1 and 2 on a parsed trace: the problems found, [] if none."""
    problems = list(validate_chrome_trace(obj))
    problems += check_span_nesting(obj["traceEvents"])
    names = {e["name"] for e in obj["traceEvents"]}
    missing = [s for s in LIFECYCLE_SPANS if s not in names]
    if missing:
        problems.append(f"missing lifecycle spans: {missing}")
    missing = [s for s in REQUIRED_INSTANTS if s not in names]
    if missing:
        problems.append(f"missing instant events: {missing}")
    return problems


def run(params=None, device=None):
    """The scenario twice, traced. `params`: the port's weights of
    `model_config()`, or None for random ones from seed 0. Returns
    (problems, the first run's trace bytes)."""
    dev = resolve_device(device)
    cfg = model_config()
    if params is None:
        params = transformer.init_model(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        paths = [pathlib.Path(tmp) / f"run{i}.json" for i in (1, 2)]
        for p in paths:
            run_loadgen(cfg, scenario(), params=params, device=dev,
                        wrap_endpoint=FaultInjector(fault_plan()),
                        trace_path=p)
        blobs = [p.read_bytes() for p in paths]
    problems = []
    if blobs[0] != blobs[1]:
        problems.append("same-seed runs wrote different trace bytes")
    obj = json.loads(blobs[0])
    problems += check_trace(obj)
    names = {e["name"] for e in obj["traceEvents"]}
    print(f"trace_smoke: {len(obj['traceEvents'])} events, "
          f"{len(names)} distinct names, two runs byte-identical="
          f"{blobs[0] == blobs[1]}")
    return problems, blobs[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' on purpose)")
    args = ap.parse_args(argv)
    problems, _ = run(device=args.device)
    for p in problems:
        print(f"trace_smoke: FAIL: {p}", file=sys.stderr)
    if not problems:
        print("trace_smoke: OK")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
