"""Federated split training over the wire: activations up, compressed cut
gradients down (`core.wire` `grad` frames), the party boundary a detached
tensor on each side. `client` runs the bottom models and the encode half
and applies returned gradients; `server` batches through
`runtime.batching`, runs the top model and the loss and streams grad
frames back; `schedule` adapts the per-step (k, bits) to training
progress (Oh et al. 2023); `async_policy` trades staleness for
communication (Chen et al. 2021); `engine.run_fedtrain` orchestrates,
checkpoints every party through `checkpoint.store`, and accounts both
directions' bytes from real frames. The port of the reference's
`repro.fedtrain`.
"""
from repro_torch.fedtrain.async_policy import AsyncPolicy
from repro_torch.fedtrain.client import TrainingClient
from repro_torch.fedtrain.engine import run_fedtrain
from repro_torch.fedtrain.schedule import KScheduler, ScheduleSpec
from repro_torch.fedtrain.server import TrainingServer

__all__ = ["AsyncPolicy", "KScheduler", "ScheduleSpec", "TrainingClient",
           "TrainingServer", "run_fedtrain"]
