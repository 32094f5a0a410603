"""Paper Table 3 (CIFAR-100 block): accuracy against compressed size for
every method at High/Medium/Low compression, on the synthetic 100-class
task; the counterpart of `benchmarks/table3_accuracy.py`.

Claims checked (paper Section 5.2):
  * RandTopk >= Topk at every compression level;
  * Topk and RandTopk >> size reduction at high compression (many classes);
  * vanilla (no compression) is the accuracy ceiling.
"""
import numpy as np

from repro_torch.experiments import common
from repro_torch.experiments.common import EPOCHS, SEEDS, dataset, spec
from repro_torch.split.tabular import train

LEVELS = {"high": 3, "medium": 6, "low": 13}


def run_method(method, seeds=None, device=None, **kw):
    accs, sizes = [], []
    for s in range(SEEDS if seeds is None else seeds):
        r = train(spec(method, **kw), dataset(), epochs=EPOCHS, seed=s,
                  device=device)
        accs.append(r["test_acc"])
        sizes.append(r["compressed_size_pct"])
    return float(np.mean(accs)), float(np.std(accs)), float(np.mean(sizes))


def checks(results):
    """The validated orderings, from {(method, level): (acc, std,
    size)}."""
    out = {}
    for level in LEVELS:
        out[f"randtopk>=topk@{level}"] = (
            results[("randtopk", level)][0] >=
            results[("topk", level)][0] - 0.01)
        out[f"topk>sizered@{level}"] = (
            results[("topk", level)][0] > results[("size_reduction",
                                                   level)][0])
    out["none_is_ceiling"] = all(
        results[("none", "-")][0] >= v[0] - 0.02 for v in results.values())
    return out


def main(emit=print, device=None):
    dev = common.device(device)
    results = {}
    acc, std, size = run_method("none", device=dev)
    results[("none", "-")] = (acc, std, size)
    emit(f"table3,none,-,{acc:.4f},{std:.4f},{size:.2f}")
    for level, k in LEVELS.items():
        for method in ["randtopk", "topk", "size_reduction"]:
            kw = {"k": k}
            if method == "randtopk":
                kw["alpha"] = 0.1
            acc, std, size = run_method(method, device=dev, **kw)
            results[(method, level)] = (acc, std, size)
            emit(f"table3,{method},{level},{acc:.4f},{std:.4f},{size:.2f}")
    # quantization: only 4-bit (12.5%) is in the Low band
    acc, std, size = run_method("quant", device=dev, quant_bits=4)
    results[("quant", "low")] = (acc, std, size)
    emit(f"table3,quant,low,{acc:.4f},{std:.4f},{size:.2f}")
    acc, std, size = run_method("l1", device=dev, l1_lam=1e-3)
    results[("l1", "-")] = (acc, std, size)
    emit(f"table3,l1,-,{acc:.4f},{std:.4f},{size:.2f}")

    out = checks(results)
    for name, ok in out.items():
        emit(f"table3_check,{name},{ok}")
    return results, out


if __name__ == "__main__":
    main()
