from .adamw import OptConfig, adamw_init, adamw_update, global_norm, lr_at

__all__ = ["OptConfig", "adamw_init", "adamw_update", "global_norm",
           "lr_at"]
