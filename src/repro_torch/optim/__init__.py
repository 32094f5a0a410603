from repro_torch.optim.adamw import adamw_init, adamw_update, sgd_init, sgd_update
from repro_torch.optim.schedule import cosine_schedule, linear_warmup_cosine

__all__ = ["adamw_init", "adamw_update", "sgd_init", "sgd_update",
           "cosine_schedule", "linear_warmup_cosine"]
