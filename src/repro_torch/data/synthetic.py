"""Synthetic many-class classification datasets for the paper-scale
experiments (offline stand-in for CIFAR-100 / DBPedia / Tiny-ImageNet).

Construction: each class c gets a fixed random template t_c in R^{in_dim};
a sample is `rotate(t_c) + noise` pushed through a fixed random nonlinear
mixing layer, which makes the task non-linearly-separable (an MLP must learn
real features) while keeping difficulty controllable via `noise`.
The generator is deterministic in (seed, n_classes, dims). The port's own
copy of the reference's `data/synthetic.py` (numpy only), so both packages
draw the same samples from the same seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ManyClassDataset:
    n_classes: int = 100
    in_dim: int = 64
    n_train: int = 20000
    n_test: int = 4000
    noise: float = 0.9
    seed: int = 0

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        self.templates = rng.randn(self.n_classes, self.in_dim).astype(np.float32)
        self.templates /= np.linalg.norm(self.templates, axis=1, keepdims=True)
        self.mix_w = (rng.randn(self.in_dim, self.in_dim) /
                      np.sqrt(self.in_dim)).astype(np.float32)
        self.mix_b = (0.1 * rng.randn(self.in_dim)).astype(np.float32)
        self.x_train, self.y_train = self._make(rng, self.n_train)
        self.x_test, self.y_test = self._make(rng, self.n_test)

    def _make(self, rng, n):
        y = rng.randint(0, self.n_classes, size=n)
        base = self.templates[y]
        x = base + self.noise * rng.randn(n, self.in_dim).astype(np.float32)
        x = np.tanh(x @ self.mix_w + self.mix_b)  # fixed nonlinear mixing
        return x.astype(np.float32), y.astype(np.int32)

    def batches(self, batch_size: int, *, rng: np.random.RandomState):
        idx = rng.permutation(self.n_train)
        for i in range(0, self.n_train - batch_size + 1, batch_size):
            sel = idx[i: i + batch_size]
            yield self.x_train[sel], self.y_train[sel]
