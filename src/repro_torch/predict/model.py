"""Straggler-prediction MLP: torch init/training path, numpy inference
path (DESIGN.md §20).

The parameter tree is one flat dict so the two worlds stay trivially
interchangeable:

- ``w0/b0/w1/b1`` — the trained net (features → hidden → 1 logit);
- ``mu/sd`` — corpus normalization statistics, computed on the *train*
  split and carried as frozen leaves (never touched by the optimizer —
  weight decay on ``sd`` would drive the normalizer to zero).

``forward_np`` is the inference path, so ``PredictorPolicy`` scores in
float64 numpy on every device; ``forward_torch`` is the same arithmetic
on tensors for the training loop. Checkpoints go through
``repro_torch.checkpoint.manager``; :func:`load_params_np` reads the
``manifest.json`` + ``leaf_*.npy`` layout back with numpy alone. The
layout is the reference package's, so a checkpoint written by either
package's ``train`` loads in the other.

The reference draws its initial weights from JAX's random stream, which
torch cannot reproduce: :func:`init_params` draws the same distributions
from a seeded ``torch.Generator``, and :func:`from_jax_params` carries
the reference's own weights across when two runs must start alike.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.accel.torch_backend import require_device
from repro_torch.predict.features import N_FEATURES

N_HIDDEN = 16

Params = Dict[str, np.ndarray]
TorchParams = Dict[str, torch.Tensor]

# Optimizer-visible leaves, in the flat dict. mu/sd are normalization
# constants: restored, broadcast, never updated.
TRAINED_LEAVES = ("w0", "b0", "w1", "b1")
FROZEN_LEAVES = ("mu", "sd")


def default_params(n_features: int = N_FEATURES,
                   hidden: int = N_HIDDEN) -> Params:
    """Checkpoint-less fallback: a zero net with a negative output bias.
    Every score is sigmoid(-2) ≈ 0.12 — below any sane threshold — so an
    untrained predictor degenerates to "reap + failure detection, never
    speculate". Deterministic, and needs no training."""
    return {
        "w0": np.zeros((n_features, hidden)),
        "b0": np.zeros(hidden),
        "w1": np.zeros((hidden, 1)),
        "b1": np.full(1, -2.0),
        "mu": np.zeros(n_features),
        "sd": np.ones(n_features),
    }


def init_params(seed: int, n_features: int = N_FEATURES,
                hidden: int = N_HIDDEN, *,
                device: Union[str, torch.device] = "cuda") -> TorchParams:
    """Seeded float32 init with the reference's distributions: fan-in
    normals (scale ``shape[0] ** -0.5``, w0 drawn before w1), zero biases,
    ``mu`` 0 and ``sd`` 1. The draws come from a ``torch.Generator`` on
    the CPU seeded with ``seed`` and are then moved to ``device``, so
    every device starts from the same bits."""
    dev = require_device(str(device), "init_params")
    gen = torch.Generator().manual_seed(seed)

    def normal(shape):
        return torch.randn(shape, generator=gen,
                           dtype=torch.float32) * shape[0] ** -0.5

    params = {
        "w0": normal((n_features, hidden)),
        "b0": torch.zeros(hidden),
        "w1": normal((hidden, 1)),
        "b1": torch.zeros(1),
        "mu": torch.zeros(n_features),
        "sd": torch.ones(n_features),
    }
    return {k: v.to(dev) for k, v in params.items()}


def from_jax_params(params: Mapping[str, object], *,
                    device: Union[str, torch.device] = "cuda"
                    ) -> TorchParams:
    """The reference's flat parameter dict (numpy leaves, e.g. its
    ``init_params`` converted with ``np.asarray``) as the port's float32
    tensors on ``device``."""
    dev = require_device(str(device), "from_jax_params")
    return {k: torch.tensor(np.asarray(v, dtype=np.float32), device=dev)
            for k, v in params.items()}


def forward_np(params: Params, X: np.ndarray) -> np.ndarray:
    """Logits for a feature matrix — pure numpy, float64, the live
    assessment-tick path (deterministic across platforms)."""
    z = (np.asarray(X, dtype=np.float64) - np.asarray(params["mu"],
                                                      dtype=np.float64)) \
        / np.asarray(params["sd"], dtype=np.float64)
    h = np.maximum(z @ np.asarray(params["w0"], dtype=np.float64)
                   + np.asarray(params["b0"], dtype=np.float64), 0.0)
    out = h @ np.asarray(params["w1"], dtype=np.float64) \
        + np.asarray(params["b1"], dtype=np.float64)
    return out[:, 0]


def forward_torch(params: Mapping[str, torch.Tensor],
                  X: torch.Tensor) -> torch.Tensor:
    """Same arithmetic as :func:`forward_np` on tensors (training). The
    ReLU is ``torch.maximum`` against zero, whose gradient at a tie is
    split in half as ``jnp.maximum``'s is."""
    z = (X - params["mu"]) / params["sd"]
    pre = z @ params["w0"] + params["b0"]
    h = torch.maximum(pre, torch.zeros_like(pre))
    return (h @ params["w1"] + params["b1"])[:, 0]


def sigmoid_np(logits: np.ndarray) -> np.ndarray:
    out = np.empty_like(logits, dtype=np.float64)
    pos = logits >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-logits[pos]))
    e = np.exp(logits[~pos])
    out[~pos] = e / (1.0 + e)
    return out


def scores_np(params: Params, X: np.ndarray) -> np.ndarray:
    return sigmoid_np(forward_np(params, X))


# ---------------------------------------------------------------------------
# Checkpoint loading with numpy alone
# ---------------------------------------------------------------------------
def _step_dir(ckpt_dir: str, step: Optional[int] = None) -> str:
    """``ckpt_dir`` itself when it holds ``manifest.json``, else its
    newest ``step_*`` child (or the one matching ``step``)."""
    if os.path.exists(os.path.join(ckpt_dir, "manifest.json")):
        return ckpt_dir
    steps = sorted(
        (int(name.split("_", 1)[1]), name)
        for name in os.listdir(ckpt_dir) if name.startswith("step_"))
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    if step is None:
        return os.path.join(ckpt_dir, steps[-1][1])
    match = [name for s, name in steps if s == step]
    if not match:
        raise FileNotFoundError(
            f"no step_{step} checkpoint under {ckpt_dir}")
    return os.path.join(ckpt_dir, match[0])


def load_params_np(ckpt_dir: str, step: Optional[int] = None) -> Params:
    """Read a checkpoint with numpy alone.

    ``ckpt_dir`` is either one ``step_*`` directory (contains
    ``manifest.json``) or a manager root (the newest ``step_*`` child is
    taken, or the one matching ``step``). The manifest's ``leaves`` map
    gives ``leaf_XXXXX.npy → flat key``; our param tree is one flat dict,
    so the key path is the leaf name itself.
    """
    d = _step_dir(ckpt_dir, step)
    with open(os.path.join(d, "manifest.json")) as fh:
        manifest = json.load(fh)
    params: Params = {}
    for fname, key in manifest["leaves"].items():
        params[str(key)] = np.load(os.path.join(d, fname))
    missing = [k for k in TRAINED_LEAVES + FROZEN_LEAVES if k not in params]
    if missing:
        raise ValueError(f"checkpoint {d} missing leaves: {missing}")
    return params


def checkpoint_metadata(ckpt_dir: str, step: Optional[int] = None) -> Dict:
    """The training-time metadata blob (threshold, metrics, split) of the
    newest checkpoint; ``step`` is accepted and ignored."""
    d = _step_dir(ckpt_dir)
    with open(os.path.join(d, "manifest.json")) as fh:
        return json.load(fh).get("metadata") or {}
