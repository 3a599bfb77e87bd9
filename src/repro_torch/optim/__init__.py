from repro_torch.optim.adamw import (OptState, adamw_update,
                                     clip_by_global_norm, init_opt_state,
                                     lr_schedule, opt_state_specs)

__all__ = ["OptState", "adamw_update", "clip_by_global_norm",
           "init_opt_state", "lr_schedule", "opt_state_specs"]
