"""Paper Figure 5: the distribution of top-k neuron selections at
inference, the counterpart of `benchmarks/fig5_distribution.py`.

After training, the whole train set goes through the bottom model and the
(deterministic) top-k kernel counts how often each of the d cut neurons is
selected. Reported: min/max counts and the normalized entropy of the
histogram. Only the alpha-monotonicity trend is a check; the topk against
randtopk balance gap is reported (the reference's note: it does not
reproduce on the synthetic MLP task).
"""
import numpy as np
import torch

from repro_torch.core import selection
from repro_torch.experiments import common
from repro_torch.experiments.common import EPOCHS, dataset, spec
from repro_torch.split.tabular import bottom_fn, train


@torch.no_grad()
def selection_histogram(bottom, k, x):
    o = bottom_fn(bottom, torch.from_numpy(x).to(bottom["w1"].device))
    mask = selection.topk_mask(o, k)
    return mask.sum(dim=0).cpu().numpy()  # (d,) counts


def norm_entropy(counts):
    p = counts / max(1.0, counts.sum())
    p = p[p > 0]
    return float(-(p * np.log(p)).sum() / np.log(len(counts)))


def checks(stats):
    return {
        "larger_alpha_more_balanced":
            stats["randtopk_a3"][1] >= stats["randtopk"][1] - 0.01,
    }


def main(emit=print, device=None):
    dev = common.device(device)
    ds = dataset()
    stats = {}
    deep = max(EPOCHS, int(EPOCHS * 2))  # histogram read after convergence
    for method, kw in [("topk", dict(k=3)),
                       ("randtopk", dict(k=3, alpha=0.1)),
                       ("randtopk_a3", dict())]:
        if method == "randtopk_a3":
            sp = spec("randtopk", k=3, alpha=0.3)
        else:
            sp = spec(method, **kw)
        r = train(sp, ds, epochs=deep, seed=0, device=dev)
        counts = selection_histogram(r["bottom"], 3, ds.x_train)
        ent = norm_entropy(counts)
        stats[method] = (counts, ent)
        emit(f"fig5,{method},min={counts.min():.0f},max={counts.max():.0f},"
             f"dead={(counts == 0).sum()},entropy={ent:.4f}")
    emit(f"fig5_info,topk_vs_randtopk_balance_gap,"
         f"{stats['topk'][1] - stats['randtopk'][1]:+.4f}")
    out = checks(stats)
    for name, ok in out.items():
        emit(f"fig5_check,{name},{ok}")
    return stats, out


if __name__ == "__main__":
    main()
