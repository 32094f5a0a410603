"""Checkpoints of nested dicts of tensors: flat-key npz files with dtype and
shape fidelity, the reference's `checkpoint/store.py` layout.

One file per step, `step_{step:08d}.npz`, written to a temporary name and
moved into place with `os.replace`, so a reader never sees half a file.
Keys join the dict path with "/". Leaves are tensors (any device) or numpy
arrays and scalars; a `torch.Generator`'s state (`get_state()`, a uint8
tensor) is a tensor leaf like any other. bf16 is widened to f32 on save
(exact) and narrowed back on restore; `restore` takes a `like` tree and
gives each leaf that leaf's dtype and device, and raises on a leaf whose
shape differs.
"""
from __future__ import annotations

import os
import re
from typing import Any

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        flat = {}
        for k, v in tree.items():
            flat.update(_flatten(v, f"{prefix}{k}/"))
        return flat
    if torch.is_tensor(tree):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()                   # exact widening; restore narrows
        arr = t.numpy()
    else:
        arr = np.asarray(tree)
    return {prefix[:-1]: arr}


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **_flatten(tree))
    os.replace(tmp, path)
    return path


def _unflatten(flat: dict, like, prefix: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten(flat, v, f"{prefix}{k}/")
                for k, v in like.items()}
    key = prefix[:-1]
    arr = flat[key]
    shape = tuple(like.shape) if hasattr(like, "shape") else ()
    if arr.shape != shape:
        raise ValueError(f"checkpoint leaf {key}: shape {arr.shape}, "
                         f"expected {shape}")
    if torch.is_tensor(like):
        return torch.from_numpy(arr).to(dtype=like.dtype, device=like.device)
    return np.asarray(arr, dtype=np.asarray(like).dtype)


def restore(ckpt_dir: str, step: int, like: Any) -> Any:
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    with np.load(path) as data:
        flat = dict(data)
    return _unflatten(flat, like)


def latest_step(ckpt_dir: str) -> int:
    if not os.path.isdir(ckpt_dir):
        return -1
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.match(r"step_(\d+)\.npz$", f))]
    return max(steps) if steps else -1
