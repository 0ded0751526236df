from repro_torch.optim.adamw import (OptState, adamw_init_specs, adamw_update,
                                     cosine_schedule)

__all__ = ["OptState", "adamw_init_specs", "adamw_update", "cosine_schedule"]
