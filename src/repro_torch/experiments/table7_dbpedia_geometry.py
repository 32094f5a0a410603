"""Paper Table 7 analogue: a second task geometry (DBPedia: d=600 cut,
219 classes) to confirm that the method ordering is not an artifact of the
CIFAR-like geometry; the counterpart of
`benchmarks/table7_dbpedia_geometry.py`. k=2 gives the paper's 0.44%
"High+" compressed size, k=9 its 1.97% "Medium"."""
from repro_torch.data.synthetic import ManyClassDataset
from repro_torch.experiments import common
from repro_torch.experiments.common import EPOCHS
from repro_torch.split.tabular import SplitSpec, train

_DS = None

RUNS = [
    ("none", "none", {}),
    ("randtopk_k2", "randtopk", dict(k=2, alpha=0.1)),
    ("topk_k2", "topk", dict(k=2)),
    ("sizered_k2", "size_reduction", dict(k=2)),
    ("randtopk_k9", "randtopk", dict(k=9, alpha=0.1)),
    ("topk_k9", "topk", dict(k=9)),
    ("sizered_k9", "size_reduction", dict(k=9)),
]


def dataset():
    global _DS
    if _DS is None:
        _DS = ManyClassDataset(n_classes=219, in_dim=128, n_train=20000,
                               n_test=4000, noise=0.25, seed=1)
    return _DS


def checks(results):
    return {
        "randtopk>=topk@high+": results["randtopk_k2"] >=
            results["topk_k2"] - 0.01,
        "topk>sizered@high+": results["topk_k2"] > results["sizered_k2"],
        "randtopk>=topk@medium": results["randtopk_k9"] >=
            results["topk_k9"] - 0.01,
        "topk>sizered@medium": results["topk_k9"] > results["sizered_k9"],
    }


def main(emit=print, device=None):
    dev = common.device(device)
    results = {}
    for name, method, kw in RUNS:
        sp = SplitSpec(method=method, cut_dim=600, n_classes=219,
                       in_dim=128, hidden=512, lr=2e-3, **kw)
        r = train(sp, dataset(), epochs=max(10, EPOCHS // 2), seed=0,
                  device=dev)
        results[name] = r["test_acc"]
        emit(f"table7,{name},{r['test_acc']:.4f},"
             f"{r['compressed_size_pct']:.2f}")
    out = checks(results)
    for name, ok in out.items():
        emit(f"table7_check,{name},{ok}")
    return results, out


if __name__ == "__main__":
    main()
