from repro_torch.checkpoint.store import latest_step, restore, save

__all__ = ["save", "restore", "latest_step"]
