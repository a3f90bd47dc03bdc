"""Train/serve step builders.

``make_prefill_step`` and ``make_serve_step`` produce the serving path's
steps, as the reference's do. ``make_train_step`` and the train-state
builders raise until the training slice ports the backward kernels B7/B8,
AdamW and the gradient compression (ROADMAP Queue A).

``TrainConfig.impl`` defaults to ``"kernel"``: the attention kernels B6
and B9 on CUDA tensors, their plain torch versions on CPU tensors;
``"ref"`` asks for the plain oracles. The reference defaults to ``"ref"``
(``repro/train/loop.py``); the port differs because its main path on the
card must go through its kernels. The reference's ``unroll`` knob has no
counterpart: the port's layer loop is a Python loop.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as MODEL

_TRAINING = ("training is not ported yet: it waits for the backward "
             "kernels B7/B8 and the optimizer (see ROADMAP.md)")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    microbatches: int = 1
    remat: str = "none"            # none | full | dots | dots_no_batch
    impl: str = "kernel"           # attention kernel impl: kernel | ref
    grad_compression: bool = False  # error-feedback int8
    lr_schedule: Optional[Callable] = None

    def lr(self):
        return self.lr_schedule if self.lr_schedule is not None \
            else self.learning_rate


# ---------------------------------------------------------------------------
# State and train step: not ported yet
# ---------------------------------------------------------------------------
def train_state_init(cfg: ModelConfig, key, tc: TrainConfig):
    raise NotImplementedError(f"train_state_init: {_TRAINING}")


def train_state_shapes(cfg: ModelConfig, tc: TrainConfig):
    raise NotImplementedError(f"train_state_shapes: {_TRAINING}")


def train_state_axes(cfg: ModelConfig, tc: TrainConfig):
    raise NotImplementedError(f"train_state_axes: {_TRAINING}")


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    raise NotImplementedError(f"make_train_step: {_TRAINING}")


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------
def make_serve_step(cfg: ModelConfig, tc: TrainConfig):
    def serve_step(params, cache, tokens, pos):
        return MODEL.decode_step(cfg, params, cache, tokens, pos,
                                 impl=tc.impl)
    return serve_step


def make_prefill_step(cfg: ModelConfig, tc: TrainConfig,
                      max_len: Optional[int] = None):
    def prefill_step(params, batch):
        return MODEL.prefill(cfg, params, batch, max_len=max_len,
                             impl=tc.impl)
    return prefill_step
