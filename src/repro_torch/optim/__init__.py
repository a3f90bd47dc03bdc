from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.schedule import cosine_schedule, linear_warmup_cosine
from repro_torch.optim.compress import (
    ef_int8_compress,
    ef_int8_decompress,
    ef_state_init,
    error_feedback_step,
)

__all__ = [
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "linear_warmup_cosine",
    "ef_int8_compress",
    "ef_int8_decompress",
    "ef_state_init",
    "error_feedback_step",
]
