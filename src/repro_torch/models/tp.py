"""The tensor-parallel lm head of the sharded serving arena, the serving
half of the reference's `src/repro/models/tp.py` (docs/sharding.md, "The
tensor-parallel head"). Both functions take and return one tensor per
mesh position (`repro_torch.mesh.Mesh`) and move data only through the
mesh's collectives, which count their bytes into `registry` when given."""
from __future__ import annotations

import torch

from repro_torch import mesh as mesh_mod

INT32_MAX = torch.iinfo(torch.int32).max


def gather_seq_local(mesh, blocks, axis_name: str = "model",
                     registry=None):
    """The Megatron-SP gather: each position's row block concatenated with
    its `axis_name` group's, in the activation dtype it came in (the
    caller applies the final norm first). Rows stand in for the sequence
    axis of the reference's (B, S/model, d) activation."""
    return mesh_mod.all_gather(mesh, blocks, axis_name, dim=0,
                               registry=registry)


def vocab_parallel_argmax(mesh, logits, axis_name: str = "model",
                          registry=None):
    """Exact greedy argmax over a vocab sharded along `axis_name`: each
    position holds a contiguous (rows, V/model) column shard, shard i
    starting at column i * V/model.

      1. per-shard max and argmax (first occurrence), plus the shard's
         base column;
      2. the global max over the group (an all-reduce max; the maxima
         travel as f32, exact for any narrower float);
      3. shards whose max equals it propose their index, the others
         INT32_MAX; the group's minimum proposal is the lowest global
         column attaining the max — `torch.argmax`'s first occurrence over
         the whole padded vocab.

    Returns int32 (rows,) per position, equal across each group."""
    v_local = logits[0].shape[-1]
    local_max = [x.amax(dim=-1).float() for x in logits]
    global_max = mesh_mod.all_reduce(mesh, local_max, axis_name, "max",
                                     registry=registry)
    proposals = []
    for p, x in enumerate(logits):
        base = mesh.coord(p, axis_name) * v_local
        idx = torch.argmax(x, dim=-1).to(torch.int32) + base
        proposals.append(torch.where(local_max[p] == global_max[p], idx,
                                     torch.full_like(idx, INT32_MAX)))
    return mesh_mod.all_reduce(mesh, proposals, axis_name, "min",
                               registry=registry)
