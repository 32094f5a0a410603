"""FLOPs, bytes, peak memory and collective bytes of a torch program, counted
as it runs: the port's counterpart of the reference's
`src/repro/roofline/hlo.py`.

The reference parses the compiled, partitioned HLO text of a step. The
port has no compiler, so `count_program` is one `TorchDispatchMode` that
sees every aten op the step runs (forward, the remat recompute under
`torch.utils.checkpoint` and the backward alike), on any device; on the
`meta` device nothing is allocated (`launch/dryrun.py`). Under the
reference's conventions:

  * flops: 2 * M * N * K for every matmul-like op (the formulas of
    `torch.utils.flop_counter`, the convention of `hlo.program_costs`'
    dots); a recomputed layer counts again, as the reference's remat dots
    do. Elementwise work counts nothing.
  * bytes: every op's materialized output counted twice (written, then
    read once), the reference's rule. A view (an output that aliases an
    input without writing it) counts nothing, standing in for the
    reference's fusion internals. The port's program is unfused, so this
    count is larger than XLA's for the same step (PERF.md gives the
    measured ratio).
  * peak: the largest sum of the storages that ops made and that are
    still alive, above whatever existed before the mode (the program's
    arguments). Each new storage registers once, keyed by
    `untyped_storage()._cdata`, and leaves through a `weakref.finalize`
    on the storage itself, which fires when its last view dies (one on a
    tensor would fire while views of it live on).
  * collectives: the run's registry (`Runtime.registry`, counted by
    `repro_torch.mesh`), read as the difference of two snapshots.
    `mesh` counts each collective once, at one position's output bytes:
    already the per-device figure that the reference's per-partition
    HLO shapes give. `CollectiveStats` prices them by
    `analysis.RING_FACTOR`.

`attention_score_bytes` (`hlo.py:351`) has no counterpart: neither
`analysis.from_program` nor the dry run reads it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch import mesh as mesh_mod
from repro_torch.roofline.analysis import RING_FACTOR


@dataclasses.dataclass
class CollectiveStats:
    """Per-op raw collective bytes per device (`hlo.CollectiveStats`)."""

    per_op_bytes: Dict[str, float]

    @property
    def total_link_bytes(self) -> float:
        return sum(RING_FACTOR.get(op, 1.0) * b
                   for op, b in self.per_op_bytes.items())

    @property
    def raw_bytes(self) -> Dict[str, float]:
        return dict(self.per_op_bytes)


@dataclasses.dataclass
class ProgramCounts:
    """What `count_program` counted: whole-program flops and bytes (every
    mesh position's work: the single controller runs them all), the
    peak of live storage bytes above the arguments, and the registry's
    collective bytes."""

    flops: int = 0
    bytes: int = 0
    peak: int = 0
    collectives: CollectiveStats = dataclasses.field(
        default_factory=lambda: CollectiveStats({}))


# ops whose output is a fresh tensor by schema but, by use, a reshape of
# one just made (matmul's decomposition): not materialized again
_NOT_MATERIALIZED = {torch.ops.aten._unsafe_view.default}


def _aliases(func) -> bool:
    """Whether an op's output aliases an input (a view, or an in-place or
    out= op): it registers no new storage."""
    return any(r.alias_info is not None for r in func._schema.returns)


def _is_view(func) -> bool:
    return func in _NOT_MATERIALIZED or any(
        r.alias_info is not None and not r.alias_info.is_write
        for r in func._schema.returns)


class _Counter(TorchDispatchMode):

    def __init__(self, counts: ProgramCounts):
        super().__init__()
        self.counts = counts
        self.live = 0
        self.seen = set()
        self.kinds: dict = {}

    def _free(self, key, nbytes):
        self.seen.discard(key)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        fn = flop_registry.get(func.overloadpacket)
        if fn is not None:
            self.counts.flops += int(fn(*args, **kwargs, out_val=out))
        kind = self.kinds.get(func)
        if kind is None:
            kind = self.kinds[func] = (_is_view(func), _aliases(func))
        view, alias = kind
        if view:
            return out
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            self.counts.bytes += 2 * t.numel() * t.element_size()
            if alias:
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.seen:
                continue
            self.seen.add(key)
            self.live += st.nbytes()
            weakref.finalize(st, self._free, key, st.nbytes())
            self.counts.peak = max(self.counts.peak, self.live)
        return out


def collective_stats(registry) -> CollectiveStats:
    """The collective bytes `registry` (a `MetricsRegistry`, or None)
    holds, per op."""
    held = {} if registry is None else mesh_mod.collective_bytes(
        registry.snapshot())
    return CollectiveStats({op: float(b) for op, b in held.items() if b})


@contextlib.contextmanager
def count_program(registry=None):
    """Count the ops run inside the block; yields a `ProgramCounts`, filled
    in as they run and, at exit, with the collective bytes `registry` (a
    `MetricsRegistry`, the run's `Runtime.registry`) gained inside."""
    counts = ProgramCounts()
    before = collective_stats(registry).per_op_bytes
    with _Counter(counts):
        yield counts
    after = collective_stats(registry).per_op_bytes
    counts.collectives = CollectiveStats({
        op: b - before.get(op, 0.0) for op, b in after.items()
        if b != before.get(op, 0.0)})
