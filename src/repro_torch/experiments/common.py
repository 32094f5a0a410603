"""Shared configuration of the paper-scale experiments, the counterpart of
the reference's `benchmarks/common.py`.

CIFAR-100-like geometry: d=128 cut, 100 classes; k in {3, 6, 13} gives the
paper's High/Medium/Low compressed sizes (2.86 / 5.71 / 12.38 %). EPOCHS
and SEEDS are read from the environment when the module is imported
(`run --fast` sets them before it imports the sections).
"""
import os

import torch

from repro_torch.data.synthetic import ManyClassDataset
from repro_torch.runtime.engine import resolve_device
from repro_torch.split.tabular import SplitSpec

EPOCHS = int(os.environ.get("REPRO_BENCH_EPOCHS", "24"))
SEEDS = int(os.environ.get("REPRO_BENCH_SEEDS", "2"))
HIDDEN = 512
LR = 2e-3

_DS = None


def dataset() -> ManyClassDataset:
    global _DS
    if _DS is None:
        _DS = ManyClassDataset(n_classes=100, in_dim=64, n_train=20000,
                               n_test=4000, noise=0.3, seed=0)
    return _DS


def spec(method: str, **kw) -> SplitSpec:
    kw.setdefault("hidden", HIDDEN)
    kw.setdefault("lr", LR)
    return SplitSpec(method=method, **kw)


def device(name=None) -> torch.device:
    """The device every section runs on: the card when `name` is None
    (raises without CUDA), else `name` ("cpu" to run on the CPU on
    purpose)."""
    return resolve_device(name)
