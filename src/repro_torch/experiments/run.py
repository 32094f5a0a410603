"""The experiments' driver, one section per paper table or figure; the
counterpart of `benchmarks/run.py`.

    PYTHONPATH=src python -m repro_torch.experiments.run            # all
    PYTHONPATH=src python -m repro_torch.experiments.run --fast     # reduced
    PYTHONPATH=src python -m repro_torch.experiments.run --only table3
    PYTHONPATH=src python -m repro_torch.experiments.run --device cpu --fast

Runs on the card unless `--device cpu` is given (and raises when CUDA is
absent). Emits `name,metric,value` lines; `*_check` lines assert the
paper's qualitative claims and the driver exits 1 if any check fails.
The reference's serving and infrastructure sections (serve, loadgen,
roofline, wire) are not here: they belong to the port's benchmark.
"""
import argparse
import os
import sys
import time

SECTIONS = ("table2", "fig2", "table3", "fig4", "fig5", "alpha", "combined",
            "ef", "table7", "privacy", "fedtrain")
#: the reference's sections that measure serving or infrastructure
BENCHMARK_SECTIONS = ("roofline", "wire", "serve", "loadgen")


def _sections():
    from repro_torch.experiments import (alpha_sweep, appendixB_privacy,
                                         combined_compression,
                                         error_feedback,
                                         fedtrain_convergence, fig2_toy,
                                         fig4_convergence, fig5_distribution,
                                         table2_sizes, table3_accuracy,
                                         table7_dbpedia_geometry)
    return {
        "table2": table2_sizes.main,
        "fig2": fig2_toy.main,
        "table3": table3_accuracy.main,
        "fig4": fig4_convergence.main,
        "fig5": fig5_distribution.main,
        "alpha": alpha_sweep.main,
        "combined": combined_compression.main,
        "ef": error_feedback.main,
        "table7": table7_dbpedia_geometry.main,
        "privacy": appendixB_privacy.main,
        "fedtrain": fedtrain_convergence.main,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="reduced epochs/seeds for CI-speed runs")
    ap.add_argument("--only", default=None,
                    help="comma-separated subset (table2,table3,fig2,...)")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    args, _ = ap.parse_known_args(argv)
    chosen = args.only.split(",") if args.only else list(SECTIONS)
    for name in chosen:
        if name in BENCHMARK_SECTIONS:
            print(f"section {name!r} measures serving or infrastructure: it "
                  f"belongs to the port's benchmark (ROADMAP.md, Queue 1 "
                  f"item 1), not to the paper's experiments",
                  file=sys.stderr)
            return 2
        if name not in SECTIONS:
            print(f"unknown section {name!r}; choose from "
                  f"{','.join(SECTIONS)}", file=sys.stderr)
            return 2
    if args.fast:
        os.environ.setdefault("REPRO_BENCH_EPOCHS", "6")
        os.environ.setdefault("REPRO_BENCH_SEEDS", "1")

    from repro_torch.experiments import common

    dev = common.device(args.device)     # raises when CUDA is absent
    sections = _sections()
    lines = []

    def emit(msg):
        print(msg, flush=True)
        lines.append(str(msg))

    t0 = time.time()
    for name in chosen:
        emit(f"## section {name}")
        sections[name](emit=emit, device=dev)
        emit(f"## section {name} done ({time.time()-t0:.0f}s elapsed)")

    failures = [l for l in lines if "_check" in l and l.endswith("False")]
    emit(f"## {len(failures)} failed checks")
    for f in failures:
        emit("FAILED: " + f)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
