"""Fedtrain convergence: accuracy per measured wire byte across policies,
the counterpart of `benchmarks/fedtrain_convergence.py`.

Runs the over-the-wire training engine (`repro_torch.fedtrain`) on the
tabular dataset with four policies (fixed-k topk, fixed-k randtopk,
adaptive-k: dense warm-up, anneal, loss-plateau drops; and async local
steps) and scores each by final accuracy per measured up+down payload
byte. Claims checked:

  * randtopk's measured up+down bytes match the Table-2 fwd+bwd analytics
    within 5%;
  * adaptive-k and async both finish with accuracy per byte >= fixed-k
    topk.

    PYTHONPATH=src python -m repro_torch.experiments.fedtrain_convergence \
        --smoke [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from repro_torch.data.synthetic import ManyClassDataset
from repro_torch.experiments import common
from repro_torch.fedtrain import AsyncPolicy, ScheduleSpec, run_fedtrain
from repro_torch.split.tabular import SplitSpec

TOL = 0.05  # measured-vs-analytic relative tolerance (acceptance bar)
K = 9       # medium compression (paper's Table-3 middle operating point)


def _setup(smoke: bool):
    if smoke:
        ds = ManyClassDataset(n_classes=20, in_dim=32, n_train=2560,
                              n_test=1024, noise=0.3, seed=0)
        spec = SplitSpec(in_dim=32, hidden=128, cut_dim=64, n_classes=20,
                         method="randtopk", k=K, lr=2e-3)
        epochs = int(os.environ.get("REPRO_BENCH_EPOCHS", "3"))
    else:
        ds = ManyClassDataset(n_classes=100, in_dim=64, n_train=20000,
                              n_test=4000, noise=0.3, seed=0)
        spec = SplitSpec(in_dim=64, hidden=512, cut_dim=128, n_classes=100,
                         method="randtopk", k=K, lr=2e-3)
        epochs = int(os.environ.get("REPRO_BENCH_EPOCHS", "12"))
    return ds, spec, epochs


def policies(base: SplitSpec, steps_hint: int) -> dict:
    """The four runs; the schedule's phases scale with the run's length
    so the dense warm-up amortizes."""
    d = base.cut_dim
    return {
        "topk": dict(spec=dataclasses.replace(base, method="topk")),
        "randtopk": dict(spec=base),
        "adaptive": dict(spec=base, schedule=ScheduleSpec(
            k=K, d=d, warmup_steps=steps_hint // 60,
            anneal_steps=max(4, steps_hint // 10), k0=min(d, K + K // 3),
            # patience capped: late plateau drops pay full-k bytes all run
            # yet evaluate at the dropped k
            k_min=K // 2, patience=min(10, max(3, steps_hint // 15)),
            drop=0.6, min_rel_improve=5e-3)),
        "async": dict(spec=base, policy=AsyncPolicy(local_steps=2,
                                                    warmup_sync=8)),
    }


def main(emit=print, smoke: bool = False, device=None) -> bool:
    dev = common.device(device)
    ds, base, epochs = _setup(smoke)
    steps_hint = epochs * (ds.n_train // 2 // 128)  # per client, 2 clients
    results = {}
    for name, kw in policies(base, steps_hint).items():
        spec = kw.pop("spec")
        r = run_fedtrain(spec, ds, n_clients=2, epochs=epochs, batch=128,
                         seed=0, device=dev, **kw)
        payload = r["payload_bytes_up"] + r["payload_bytes_down"]
        acc = r["mean_test_acc"]
        results[name] = dict(acc=acc, bytes=payload,
                             acc_per_mb=acc / (payload / 1e6), res=r)
        emit(f"fedtrain,{name},steps={r['steps']},acc={acc:.4f},"
             f"payload_B={payload},framing_B={r['header_bytes']},"
             f"acc_per_MB={results[name]['acc_per_mb']:.3f},"
             f"final_k={max(r['final_k'])},wall_s={r['wall_s']:.1f}")
        for step, loss in r["losses"][0][:: max(1, r["steps"] // 8)]:
            emit(f"fedtrain_trace,{name},{step},{loss:.4f}")

    # measured == analytic for the fixed-k randtopk run (both directions)
    r = results["randtopk"]["res"]
    ok_bytes = True
    for direction in ("up", "down"):
        m = r[f"payload_bytes_{direction}"]
        a = r[f"analytic_bytes_{direction}"]
        rel = abs(m - a) / a
        ok = rel < TOL
        ok_bytes &= ok
        emit(f"fedtrain,randtopk_bytes_{direction},measured_B={m},"
             f"analytic_B={a:.0f},rel_err={rel:.4f}")
    emit(f"fedtrain_check,randtopk_bytes_within_5pct,{ok_bytes}")

    checks = {"bytes": ok_bytes}
    for name in ("adaptive", "async"):
        ok = results[name]["acc_per_mb"] >= results["topk"]["acc_per_mb"]
        checks[name] = ok
        emit(f"fedtrain_check,{name}_acc_per_byte>=topk,{ok}")
    return all(checks.values())


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="reduced dataset/epochs (CI-speed)")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args()
    sys.exit(0 if main(smoke=args.smoke, device=args.device) else 1)
