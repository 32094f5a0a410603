"""The meshes a user builds for the sharded serving arena and the training
mesh (`Runtime.mesh`, `launch/train --mesh`): the port's
`src/repro/launch/mesh.py`, over `repro_torch.mesh.Mesh` (one process
drives every position; see that module for the collectives and their
byte counter). By default every position lies on the resolved default
device, the card, so one card hosts a (2, 2, 2) mesh; a `devices=` list
places positions on several cards.

The training mesh and the decode mesh also run with one process a
position (`launch/train --procs`, `launch.steps.make_serve_step` on a
`make_process_mesh`): `spawn` starts `mesh.size` processes, rank r
driving position r, and each builds the same `make_process_mesh`. On
the CPU, or with several processes sharing one card, they talk over
gloo (a card's tensors staged through host memory); given one card a
process (`devices=`) over NCCL, a branch that has not run yet.
"""
from __future__ import annotations

import datetime
import math
import os
import pickle
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.mesh import Mesh, ProcessMesh
from repro_torch.runtime.engine import resolve_device

#: the rendezvous' and every collective's time limit, in seconds
PG_TIMEOUT_S = 60


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


def make_process_mesh(shape, axes, devices=None) -> ProcessMesh:
    """The calling process's mesh of `shape` over `axes`, one process a
    position, inside `spawn` (torch.distributed initialised with one rank
    a position). `devices` as `make_mesh` takes it: the device the
    processes share (the one `spawn` hands each), or under `spawn(devices=
    ...)` that list, one card a position."""
    return ProcessMesh(shape, axes, _devices(devices, math.prod(shape)))


def _child(rank, world, init, backend, devices, call, results):
    try:
        with open(call, "rb") as f:
            fn, args = pickle.load(f)
        dev = torch.device(devices[rank])
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        try:
            out = fn(rank, dev, *args)
        finally:
            dist.destroy_process_group()
        # by value: a tensor shared through a descriptor would not
        # outlive this process
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def backend_for(world: int, device=None, devices=None):
    """(backend, one device a process) for `spawn`: `device` (default:
    the card) shared by every process over gloo, or `devices`, `world`
    distinct cards, over NCCL. Raises on any other choice."""
    if devices is None:
        return "gloo", [resolve_device(device)] * world
    if device is not None:
        raise ValueError("pass device= (shared, gloo) or devices= (one "
                         "card a process, NCCL), not both")
    devices = [torch.device(d) for d in devices]
    if (len(devices) != world or len(set(devices)) != world
            or any(d.type != "cuda" for d in devices)):
        raise ValueError(f"NCCL takes {world} distinct cards for {world} "
                         f"processes, got {[str(d) for d in devices]}")
    return "nccl", devices


def spawn(fn, world: int, args=(), *, device=None, devices=None,
          timeout: float | None = 600.0, store_dir=None) -> list:
    """Run `fn(rank, device, *args)` in `world` new processes (the spawn
    start method), torch.distributed initialised in each (rendezvous
    through a file in a temporary directory, made in `store_dir` when
    given; `PG_TIMEOUT_S`), and return their results in rank order.
    `device` and `devices` pick the backend (`backend_for`; the NCCL
    branch has not run yet: it needs several cards). A process that
    raises or dies, or a run that outlives `timeout` seconds (None: no
    limit but the process group's on each collective), fails the call
    with the process's traceback, and every process still running is
    terminated. The kernel library is built here first, so that the
    processes do not race to build it."""
    backend, devices = backend_for(world, device, devices)
    if any(d.type == "cuda" for d in devices):
        from repro_torch.kernels import _lib
        _lib.library()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        # the call by value, in a file: a tensor shared through a
        # descriptor costs each process a connection to this one, and a
        # large argument written down the start pipe would start the
        # processes one after another
        call = os.path.join(tmp, "call.pkl")
        with open(call, "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        procs = [ctx.Process(target=_child, daemon=True,
                             args=(r, world, init, backend,
                                   [str(d) for d in devices], call, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            return _collect(procs, results, None if timeout is None
                            else time.monotonic() + timeout)
        except BaseException:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            raise
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()


def _collect(procs, results, deadline: float | None) -> list:
    world, got = len(procs), {}
    while len(got) < world:
        try:
            rank, ok, value = results.get(timeout=0.2)
        except queue.Empty:
            dead = [r for r, p in enumerate(procs)
                    if p.exitcode is not None and r not in got]
            if dead and results.empty():
                time.sleep(0.5)  # a result may still be on its way
                if results.empty():
                    raise RuntimeError(f"process {dead[0]} of {world} died "
                                       f"with exit code "
                                       f"{procs[dead[0]].exitcode}")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{world - len(got)} of {world} processes "
                                   f"still running at the time limit")
            continue
        if not ok:
            raise RuntimeError(f"process {rank} of {world} failed:\n{value}")
        got[rank] = pickle.loads(value)
    return [got[r] for r in range(world)]
