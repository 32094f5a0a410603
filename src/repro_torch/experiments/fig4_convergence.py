"""Paper Figures 3/4: convergence in epochs and in communication volume,
the counterpart of `benchmarks/fig4_convergence.py`.

Claims checked: compressed methods reach the accuracy threshold in fewer
bytes than vanilla; RandTopk reaches a better end point than Topk;
RandTopk's generalization gap is not larger than Topk's.
"""
from repro_torch.experiments import common
from repro_torch.experiments.common import EPOCHS, dataset, spec
from repro_torch.split.tabular import train

THRESH = 0.15


def bytes_to_acc(trace, thresh=THRESH) -> float:
    """The fewest training bytes at which a traced test accuracy reached
    `thresh` (inf if none did)."""
    hit = [b for (_, b, _, a) in trace if a >= thresh]
    return min(hit) if hit else float("inf")


def checks(results, byte_to_acc):
    return {
        "compressed_beats_vanilla_on_bytes":
            byte_to_acc["randtopk"] < byte_to_acc["none"],
        "randtopk_endpoint>=topk":
            results["randtopk"]["test_acc"] >= results["topk"]["test_acc"]
            - 0.01,
        "randtopk_gap<=topk":
            results["randtopk"]["gen_gap"] <= results["topk"]["gen_gap"]
            + 0.02,
    }


def main(emit=print, device=None):
    dev = common.device(device)
    traces = {}
    results = {}
    for method, kw in [("none", {}), ("topk", dict(k=3)),
                       ("randtopk", dict(k=3, alpha=0.1))]:
        r = train(spec(method, **kw), dataset(), epochs=EPOCHS, seed=0,
                  record_every=50, device=dev)
        traces[method] = r["trace"]
        results[method] = r
        for it, byts, loss, acc in r["trace"][::4]:
            emit(f"fig4,{method},{it},{byts:.3e},{loss:.4f},{acc:.4f}")
        emit(f"fig4_final,{method},acc={r['test_acc']:.4f},"
             f"gen_gap={r['gen_gap']:.4f},bytes={r['train_bytes']:.3e}")

    byte_to_acc = {}
    for m, tr in traces.items():
        byte_to_acc[m] = bytes_to_acc(tr)
        emit(f"fig4_bytes_to_{int(THRESH*100)}pct,{m},{byte_to_acc[m]:.3e}")
    out = checks(results, byte_to_acc)
    for name, ok in out.items():
        emit(f"fig4_check,{name},{ok}")
    return traces, out


if __name__ == "__main__":
    main()
