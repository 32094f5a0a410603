"""The meshes a user builds for the sharded serving arena and the training
mesh (`Runtime.mesh`, `launch/train --mesh`): the port's
`src/repro/launch/mesh.py`, over `repro_torch.mesh.Mesh` (one process
drives every position; see that module for the collectives and their
byte counter). By default every position lies on the resolved default
device, the card, so one card hosts a (2, 2, 2) mesh; a `devices=` list
places positions on several cards.
"""
from __future__ import annotations

import math

import torch

from repro_torch.mesh import Mesh
from repro_torch.runtime.engine import resolve_device


def _devices(devices, n: int):
    if devices is None:
        return [resolve_device(None)] * n
    if isinstance(devices, (str, torch.device)):
        return [torch.device(devices)] * n
    return list(devices)


def make_mesh(shape, axes, devices=None) -> Mesh:
    """A mesh of `shape` over `axes`. `devices`: None (every position on
    the resolved default device, the card: raises without CUDA), one
    device for every position, or a list of one per position."""
    return Mesh(shape, axes, _devices(devices, math.prod(shape)))


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def make_test_mesh(shape=(1, 1), axes=("data", "model"), devices=None):
    return make_mesh(shape, axes, devices)


def make_serving_mesh(n_devices=None, *, model: int = 1, pod: int = 1,
                      devices=None) -> Mesh:
    """The sharded serving arena's mesh (docs/sharding.md): axes ('data',
    'model'), with a leading 'pod' when `pod` > 1, where 'data' takes
    every position that `model` and `pod` do not. Arena rows shard over
    every axis; the lm head is vocab-parallel over 'model'; a pod ring
    carries the cut activation across the pod boundary. `n_devices`
    (default: the length of a `devices` list, else 1) counts positions."""
    if n_devices is None:
        n_devices = 1 if devices is None or isinstance(
            devices, (str, torch.device)) else len(devices)
    if n_devices % (model * pod):
        raise ValueError(f"{n_devices} devices not divisible by "
                         f"model={model} x pod={pod}")
    data = n_devices // (model * pod)
    if pod > 1:
        return make_mesh((pod, data, model), ("pod", "data", "model"),
                         devices)
    return make_mesh((data, model), ("data", "model"), devices)
