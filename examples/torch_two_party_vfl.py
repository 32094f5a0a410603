"""Two-party vertical-federated-learning scenario through the PyTorch port,
the paper's exact setting: a feature owner and a label owner jointly train
a 100-class classifier, exchanging ONLY the compressed cut-layer payloads.
Compares the methods of the paper at matched compressed size. Runs on the
card unless `--device cpu` is given.

    PYTHONPATH=src python examples/torch_two_party_vfl.py [--device cpu]
"""
import argparse

from repro_torch.data.synthetic import ManyClassDataset
from repro_torch.split.tabular import SplitSpec, train

METHODS = [
    ("none", {}),
    ("randtopk", dict(k=3, alpha=0.1)),
    ("topk", dict(k=3)),
    ("size_reduction", dict(k=3)),
    ("quant", dict(quant_bits=4)),
]


def main(device=None, epochs=12, n_train=8000, n_test=2000):
    ds = ManyClassDataset(n_classes=100, in_dim=64, n_train=n_train,
                          n_test=n_test, noise=0.3)
    print("method          k    acc    size%   train-wire(MB)")
    rows = {}
    for method, kw in METHODS:
        spec = SplitSpec(method=method, hidden=512, lr=2e-3, **kw)
        r = train(spec, ds, epochs=epochs, seed=0, device=device)
        rows[method] = r
        print(f"{method:15s} {kw.get('k','-'):>2} {r['test_acc']:.4f} "
              f"{r['compressed_size_pct']:7.2f} "
              f"{r['train_bytes']/1e6:10.1f}")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card")
    main(device=ap.parse_args().device)
