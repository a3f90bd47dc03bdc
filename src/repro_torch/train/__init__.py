from repro_torch.train.loop import (
    TrainConfig,
    make_prefill_step,
    make_serve_step,
    make_train_step,
    train_state_init,
    train_state_shapes,
)

__all__ = [
    "TrainConfig",
    "make_prefill_step",
    "make_serve_step",
    "make_train_step",
    "train_state_init",
    "train_state_shapes",
]
