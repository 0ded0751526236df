from repro_torch.checkpoint.store import latest_step, load, save

__all__ = ["latest_step", "load", "save"]
