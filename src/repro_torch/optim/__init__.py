"""AdamW and the learning-rate schedule (port of ``repro.optim``)."""

from .adamw import OptConfig, adamw_init, adamw_update, global_norm
from .schedule import cosine_warmup

__all__ = ["OptConfig", "adamw_init", "adamw_update", "global_norm",
           "cosine_warmup"]
