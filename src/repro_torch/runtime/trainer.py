"""TrainerRuntime: model + data + optimizer wired into the coordinator,
the port of the reference's ``repro/runtime/trainer.py``.

Trains a dense registry architecture (reduced or full config) under
injected host failures, stragglers and chaos scripts, with either
recovery strategy, checkpoint/restore, and a per-step report stream. The
four host threads compute microbatch gradients on the parameters' device
(the CUDA card by default: attention through B6 forward and B7/B8
backward; the CPU when the caller passes ``device="cpu"``), and the
coordinator's bino ticks assess through ``RuntimeConfig.assess_backend``
(default: B1–B4 on the card; CPU runs pass ``"numpy"`` or
``TorchBackend("cpu")``).

Three choices keep the threads from racing and a faulted run's bits
equal to a fault-free run's:

- ``grad_fn`` takes ``torch.autograd.grad(loss, leaves)``, never
  ``loss.backward()``: the host threads share one parameter object, and
  ``.grad`` accumulation on shared leaves would race.
- ``apply_fn`` is the out-of-place AdamW (``optim.adamw``): hosts still
  hold the previous parameters, and a straggler may still read them.
- Gradients are bit-reproducible: B7 and B8 use no atomics and the
  embedding's backward (``F.embedding``) sums repeated tokens in a fixed
  order, so a microbatch computed twice, on two hosts, gives the same
  bits, and the coordinator's first-writer-wins reduce cannot tell which
  host's copy it kept.

Two rollback tiers (DESIGN.md §16.7):
- in-memory — the coordinator retries a wedged step from its pre-step
  commit point (model state only mutates on step success);
- durable  — when a step exhausts its retries (:class:`StepWedged`),
  ``run`` restores the last crash-safe checkpoint and re-runs from the
  restored step, dropping reports from rolled-back steps.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataState, TokenDataset
from repro_torch.models import layers as L
from repro_torch.models import model as MODEL
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.runtime.clock import Clock
from repro_torch.runtime.coordinator import (
    Coordinator,
    RuntimeConfig,
    StepReport,
    StepWedged,
)
from repro_torch.train.loop import TrainConfig, make_grad_fn


def checkpoint_tree(state: Dict[str, Any]) -> Dict[str, Any]:
    """The train state as nested dicts of tensors (the parameters by
    path), the form the checkpoint manager writes and restores."""
    return {"params": L.tree_leaves(state["params"]), "opt": state["opt"],
            "step": state["step"]}


class TrainerRuntime:
    def __init__(self, cfg: ModelConfig, tc: TrainConfig,
                 rt: RuntimeConfig, *, seq_len: int = 128,
                 per_shard_batch: int = 2, seed: int = 0,
                 clock: Optional[Clock] = None, chaos=None,
                 obs=None, metrics=None, device: str = "cuda",
                 params: Optional[L.ParamTree] = None):
        """Weights are ``init_params(cfg, seed, device=device)``, or
        ``params`` (carried weights, e.g. the reference's through
        ``from_jax_params``; their device wins)."""
        self.cfg = cfg
        self.tc = tc
        self.rt = rt
        self.dataset = TokenDataset(cfg.vocab_size, seq_len, seed=seed)
        self.per_shard_batch = per_shard_batch
        if params is None:
            params = MODEL.init_params(cfg, seed, device=device)
        self.device = next(params.parameters()).device
        model_grad = make_grad_fn(cfg, tc)

        def grad_fn(params, batch):
            grads, metrics = model_grad(params, batch)
            return grads, {"loss": metrics["loss"]}

        def apply_fn(state, grads):
            leaves = L.tree_leaves(state["params"])
            new_leaves, new_opt, _metrics = adamw_update(
                grads, state["opt"], leaves,
                lr=tc.lr(), b1=tc.b1, b2=tc.b2,
                weight_decay=tc.weight_decay,
                grad_clip_norm=tc.grad_clip_norm)
            return {"params": L.tree_from_leaves(state["params"], new_leaves,
                                                 trainable=True),
                    "opt": new_opt, "step": state["step"] + 1}

        def batch_fn(state: DataState) -> Dict[str, Any]:
            toks = torch.from_numpy(self.dataset.batch(
                state.shard_id, state.offset, per_shard_batch)).long()
            toks = toks.to(self.device)
            return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

        params = L.tree_from_leaves(params, L.tree_leaves(params),
                                    trainable=True)
        init_state = {"params": params,
                      "opt": adamw_init(L.tree_leaves(params)),
                      "step": torch.zeros((), dtype=torch.int32,
                                          device=self.device)}
        shards = [DataState(seed, s, rt.n_hosts, 0)
                  for s in range(rt.n_hosts)]
        self.coord = Coordinator(
            rt, grad_fn=grad_fn, apply_fn=apply_fn, batch_fn=batch_fn,
            init_state=init_state, datastates=shards,
            clock=clock, chaos=chaos, obs=obs, metrics=metrics)
        self.ckpt = (CheckpointManager(rt.checkpoint_dir)
                     if rt.checkpoint_dir else None)
        self._start_step = 0
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            self.restore()

    # ------------------------------------------------------------------
    @property
    def state(self):
        return self.coord.state

    def restore(self) -> int:
        """Load the newest checkpoint onto the parameters' device."""
        like = self.coord.state
        tree, step, meta = self.ckpt.restore(checkpoint_tree(like))
        self.coord.state = {
            "params": L.tree_from_leaves(like["params"], tree["params"],
                                         trainable=True),
            "opt": tree["opt"], "step": tree["step"]}
        self.coord.datastates = [
            DataState(**d) for d in meta["datastates"]]
        self._start_step = step
        return step

    def run(self, n_steps: int,
            on_step: Optional[Callable[[int, "TrainerRuntime"], None]] = None,
            max_durable_rollbacks: int = 2) -> List[StepReport]:
        """Run ``n_steps`` steps from the last one run (or restored)."""
        reports: List[StepReport] = []
        target = self._start_step + n_steps
        i = self._start_step
        rollbacks = 0
        while i < target:
            if on_step is not None:
                on_step(i, self)
            try:
                rep = self.coord.run_step(i)
            except StepWedged:
                # durable rollback: restore the last crash-safe checkpoint
                # and re-run from there (DESIGN.md §16.7)
                if (self.ckpt is None or self.ckpt.latest_step() is None
                        or rollbacks >= max_durable_rollbacks):
                    raise
                rollbacks += 1
                self.ckpt.wait()
                step = self.restore()
                reports = [r for r in reports if r.step < step]
                i = step
                continue
            reports.append(rep)
            if self.ckpt is not None and self.rt.checkpoint_every and \
                    (i + 1) % self.rt.checkpoint_every == 0:
                self.ckpt.save_async(
                    checkpoint_tree(self.coord.state), i + 1,
                    metadata={"datastates": [
                        dataclasses.asdict(d)
                        for d in self.coord.datastates]})
            i += 1
        # A later call continues from here; the reference restarts its
        # step labels at the restored step on every call, which would let
        # a straggler's message from an earlier step of the same label in.
        self._start_step = i
        if self.ckpt is not None:
            self.ckpt.wait()
        return reports

    # fault-injection passthroughs ---------------------------------------
    def freeze_host(self, host_id: str) -> None:
        self.coord.hosts[host_id].freeze()

    def slow_host(self, host_id: str, factor: float) -> None:
        self.coord.hosts[host_id].slow(factor)

    def mute_host(self, host_id: str, duration: float) -> None:
        self.coord.hosts[host_id].mute(duration)

    def shutdown(self) -> None:
        self.coord.shutdown()
