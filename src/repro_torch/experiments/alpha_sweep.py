"""Paper Appendix C: the impact of the randomness coefficient alpha, the
counterpart of `benchmarks/alpha_sweep.py`.

Claims: some alpha in [0.05, 0.3] beats plain top-k (alpha=0) on the
many-class task, and the best alpha is not 0. Whether a very large alpha
degrades (the paper's YooChoose observation) is reported, not checked.
"""
import numpy as np

from repro_torch.experiments import common
from repro_torch.experiments.common import EPOCHS, SEEDS, dataset, spec
from repro_torch.split.tabular import train

ALPHAS = [0.0, 0.05, 0.1, 0.2, 0.3, 0.6]
MODERATE = (0.05, 0.1, 0.2, 0.3)


def checks(accs):
    best = max(accs, key=lambda a: accs[a][0])
    return {
        "moderate_alpha_beats_topk": any(
            accs[a][0] > accs[0.0][0] for a in MODERATE),
        "best_alpha_nonzero": best > 0.0,
    }


def main(emit=print, device=None):
    dev = common.device(device)
    accs = {}
    for alpha in ALPHAS:
        runs = [train(spec("randtopk", k=3, alpha=alpha), dataset(),
                      epochs=EPOCHS, seed=s, device=dev)["test_acc"]
                for s in range(max(1, SEEDS - 1))]
        accs[alpha] = (float(np.mean(runs)), float(np.std(runs)))
        emit(f"alpha_sweep,{alpha},{accs[alpha][0]:.4f},{accs[alpha][1]:.4f}")
    out = checks(accs)
    emit(f"alpha_info,alpha06_minus_best_moderate,"
         f"{accs[0.6][0] - max(accs[a][0] for a in MODERATE):+.4f}")
    for name, ok in out.items():
        emit(f"alpha_check,{name},{ok}")
    return accs, out


if __name__ == "__main__":
    main()
