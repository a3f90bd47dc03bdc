from repro_torch.train.loop import (
    TrainConfig,
    cross_entropy_loss,
    make_grad_fn,
    make_loss_fn,
    make_prefill_step,
    make_serve_step,
    make_train_step,
    train_state_init,
    train_state_shapes,
)

__all__ = [
    "TrainConfig",
    "cross_entropy_loss",
    "make_grad_fn",
    "make_loss_fn",
    "make_prefill_step",
    "make_serve_step",
    "make_train_step",
    "train_state_init",
    "train_state_shapes",
]
