"""Train/serve step builders, the port of the reference's
``repro/train/loop.py``.

``make_train_step`` produces ``train_step(state, batch)``: microbatched
gradient accumulation (a Python loop summing float32 gradients, the
reference's ``lax.scan``; every entry of the batch — ``tokens``, the
audio and vlm families' ``feats``, ``labels`` — split along its first
axis), the reference's ``remat`` policies (``"none"``, ``"full"``,
``"dots"``, ``"dots_no_batch"``), optional error-feedback int8 gradient
compression, then AdamW. ``make_prefill_step`` and ``make_serve_step``
produce the serving path's steps. A train state is ``{"params":
ParamTree (trainable), "opt": {"m", "v", "count"}, "step"[, "ef"]}``
with the moments (and the compression residual) as dicts ``{path:
tensor}`` in :func:`~repro_torch.models.layers.tree_leaves` order.

``train_state_shapes`` and ``train_state_axes`` give the state's
``meta`` tensors and logical axes without allocating (the dry run).

``TrainConfig.impl`` defaults to ``"kernel"``: the attention kernels B6
(forward), B7/B8 (backward) and B9 (decode), and the Mamba-2 layers' SSD
scan B10 (prefill and forward; its backward is autograd of the oracle),
on CUDA tensors, their plain torch versions on CPU tensors; ``"ref"``
asks for the plain oracles. The serving steps serve every family: a
batch is handed to ``prefill``/``forward`` whole, so the audio family's
``feats`` and the vlm family's ``feats`` beside its ``tokens`` go
through (the encoder-only audio family has no decode step). The
reference defaults to ``"ref"``; the port differs because its main path
on the card must go through its kernels. The reference's ``unroll`` knob
has no counterpart: the port's layer loop is a Python loop.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import model as MODEL
from repro_torch.optim.adamw import adamw_init, adamw_update, adamw_update_
from repro_torch.optim.compress import (ef_state_init, error_feedback_step,
                                        error_feedback_step_)
from repro_torch.parallel.sharding import is_dtensor

@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    microbatches: int = 1
    remat: str = "none"            # none | full | dots | dots_no_batch
    impl: str = "kernel"           # kernel | ref | dist (decode only)
    grad_compression: bool = False  # error-feedback int8
    lr_schedule: Optional[Callable] = None

    def lr(self):
        return self.lr_schedule if self.lr_schedule is not None \
            else self.learning_rate


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Next-token xent; logits (b, s, v) any float dtype, labels (b, s)."""
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    if is_dtensor(lf):
        # vocab-parallel (the dry run's logits are sharded on the vocab):
        # each shard's masked sum, where a gather across shards has no
        # DTensor rule
        vocab = torch.arange(lf.shape[-1], device=lf.device)
        gold = torch.where(labels.long()[..., None] == vocab, lf, 0.0)
        gold = gold.sum(-1)
    else:
        gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean()


def make_loss_fn(cfg: ModelConfig, tc: TrainConfig):
    def loss_fn(params, batch):
        logits, aux, _ = MODEL.forward(cfg, params, batch, impl=tc.impl,
                                       remat=tc.remat)
        loss = cross_entropy_loss(logits, batch["labels"])
        return loss + aux, {"loss": loss, "moe_aux": aux}
    return loss_fn


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------
def train_state_init(cfg: ModelConfig,
                     generator: Union[int, torch.Generator],
                     tc: TrainConfig, *, device: str = "cuda"
                     ) -> Dict[str, Any]:
    """Random weights from ``generator`` (a seed or a seeded generator on
    ``device``), zero AdamW moments, step 0."""
    params = MODEL.init_params(cfg, generator, device=device)
    params = L.tree_from_leaves(params, L.tree_leaves(params),
                                trainable=True)
    leaves = L.tree_leaves(params)
    state = {"params": params, "opt": adamw_init(leaves),
             "step": torch.zeros((), dtype=torch.int32,
                                 device=next(params.parameters()).device)}
    if tc.grad_compression:
        state["ef"] = ef_state_init(leaves)
    return state


def train_state_shapes(cfg: ModelConfig, tc: TrainConfig) -> Dict[str, Any]:
    """The train state's layout with ``meta`` tensors as leaves, nothing
    allocated: the weights as :func:`~repro_torch.models.model.
    param_shapes` gives them, the moments (and the compression residual)
    as float32 dicts ``{path: tensor}`` in ``tree_leaves`` order."""
    params = MODEL.param_shapes(cfg)
    meta = torch.device("meta")

    def f32():
        return {path: torch.empty(t.shape, dtype=torch.float32, device=meta)
                for path, t in L.tree_leaves(params).items()}

    scalar = torch.empty((), dtype=torch.int32, device=meta)
    state = {"params": params,
             "opt": {"m": f32(), "v": f32(), "count": scalar},
             "step": scalar}
    if tc.grad_compression:
        state["ef"] = f32()
    return state


def train_state_axes(cfg: ModelConfig, tc: TrainConfig) -> Dict[str, Any]:
    """Logical-axis tree matching :func:`train_state_shapes`."""
    axes = MODEL.param_axes(cfg)
    by_path = L.tree_leaves(axes)
    state = {"params": axes,
             "opt": {"m": dict(by_path), "v": dict(by_path), "count": ()},
             "step": ()}
    if tc.grad_compression:
        state["ef"] = dict(by_path)
    return state


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------
def make_grad_fn(cfg: ModelConfig, tc: TrainConfig):
    """``grad_fn(params, batch) -> (grads {path: tensor}, metrics)``:
    ``torch.autograd.grad`` of the loss with respect to every leaf, which
    leaves the shared parameters' ``.grad`` untouched. A leaf the loss
    does not reach (the token embedding of the audio family, which reads
    frame features) gets zeros, as ``jax.grad`` gives it."""
    loss_fn = make_loss_fn(cfg, tc)

    def grad_fn(params, batch):
        leaves = L.tree_leaves(params)
        with torch.enable_grad():
            total, metrics = loss_fn(params, batch)
            grads = torch.autograd.grad(total, list(leaves.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
        return (dict(zip(leaves, grads)),
                {k: v.detach() for k, v in metrics.items()})

    return grad_fn


def make_train_step(cfg: ModelConfig, tc: TrainConfig, donate: bool = False):
    """``train_step(state, batch) -> (state, metrics)``. Out of place by
    default: the state given is left as it was. ``donate``: the state
    given is the one returned, its weights, moments, count, step (and
    compression residual) overwritten in their own storage with the same
    bits (:func:`~repro_torch.optim.adamw.adamw_update_`), the
    counterpart of the reference's step jitted with ``donate_argnums=
    (0,)``: no second copy of the state is held."""
    grad_fn = make_grad_fn(cfg, tc)
    n = tc.microbatches

    def train_step(state, batch):
        params = state["params"]
        if n > 1:
            for name, x in batch.items():
                if x.shape[0] % n:
                    raise ValueError(f"batch {name}: {x.shape[0]} rows do "
                                     f"not split into {n} microbatches")
            # float32 sums, updated in place: a second copy of the sums
            # (11.8 GB for a moonshot cut of 2.95 B parameters) and the
            # previous microbatch's gradients are not held meanwhile
            grads, metrics = None, None
            for i in range(n):
                mb = {name: x.reshape(n, x.shape[0] // n, *x.shape[1:])[i]
                      for name, x in batch.items()}
                g, m = grad_fn(params, mb)
                if grads is None:
                    grads = {k: torch.zeros(t.shape, dtype=torch.float32,
                                            device=t.device)
                             for k, t in g.items()}
                    metrics = {k: torch.zeros((), dtype=torch.float32,
                                              device=t.device)
                               for k, t in m.items()}
                for k in grads:
                    grads[k].add_(g[k].float())
                metrics = {k: metrics[k] + m[k] for k in metrics}
                del g
            for t in grads.values():
                t.div_(n)
            metrics = {k: m / n for k, m in metrics.items()}
        else:
            grads, metrics = grad_fn(params, batch)

        opt_kw = dict(lr=tc.lr(), b1=tc.b1, b2=tc.b2,
                      weight_decay=tc.weight_decay,
                      grad_clip_norm=tc.grad_clip_norm)
        metrics = dict(metrics)
        if donate:
            if tc.grad_compression:
                grads = error_feedback_step_(grads, state["ef"])
            metrics.update(adamw_update_(grads, state["opt"],
                                         L.tree_leaves(params), **opt_kw))
            state["step"].add_(1)
            return state, metrics

        new_state = dict(state)
        if tc.grad_compression:
            grads, new_ef = error_feedback_step(grads, state["ef"])
            new_state["ef"] = new_ef

        new_leaves, new_opt, opt_metrics = adamw_update(
            grads, state["opt"], L.tree_leaves(params), **opt_kw)
        new_state["params"] = L.tree_from_leaves(params, new_leaves,
                                                 trainable=True)
        new_state["opt"] = new_opt
        new_state["step"] = state["step"] + 1
        metrics.update(opt_metrics)
        return new_state, metrics

    return train_step


def make_serve_step(cfg: ModelConfig, tc: TrainConfig):
    def serve_step(params, cache, tokens, pos):
        return MODEL.decode_step(cfg, params, cache, tokens, pos,
                                 impl=tc.impl)
    return serve_step


def make_prefill_step(cfg: ModelConfig, tc: TrainConfig,
                      max_len: Optional[int] = None):
    """``prefill_step(params, batch)``: ``batch`` as ``forward`` takes it
    (``tokens``; ``feats``; or both for vlm)."""
    def prefill_step(params, batch):
        return MODEL.prefill(cfg, params, batch, max_len=max_len,
                             impl=tc.impl)
    return prefill_step
