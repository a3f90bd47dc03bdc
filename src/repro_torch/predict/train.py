"""Predictor training CLI (DESIGN.md §20): corpus → MLP checkpoint.

Reuses the port's stack end to end — :func:`repro_torch.predict.model.
init_params` (seeded fan-in normals), ``repro_torch.optim.adamw``
updates under a ``repro_torch.train.loop.TrainConfig``,
``repro_torch.checkpoint.manager`` for the committed checkpoint — on a
full-batch sigmoid-BCE objective (the corpus is thousands of rows, not
billions; minibatching would only add an rng axis to the determinism
contract). Gradients come from ``torch.autograd``; the MLP's two
products are ``torch.matmul`` (no kernel of the port serves this
model, as no Pallas kernel serves the reference's).

Deterministic from ``seed`` on one device: corpus replay, train/eval
split, init and the update loop all derive from it. The initial weights
are drawn on the CPU and moved, so every device starts from the same
bits; the card's float32 sums may then round differently from the CPU's.

Threshold calibration: the decision threshold the live policy uses is
chosen *on the train split* as the lowest score cut achieving
``target_precision`` (fallback: the max-precision cut). High precision
is what the fig_predictor false-positive gate needs — a backup launched
for a task that was never going to straggle is pure wasted work.

``train`` runs on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.accel.torch_backend import require_device
from repro_torch.predict.dataset import generate_corpus, load_corpus, \
    train_eval_split
from repro_torch.predict.features import FEATURE_NAMES
from repro_torch.predict.model import FROZEN_LEAVES, TRAINED_LEAVES, \
    forward_torch, init_params, scores_np

THRESHOLD_GRID = np.round(np.arange(0.05, 0.96, 0.05), 2)


def _precision_recall(scores: np.ndarray, y: np.ndarray,
                      thr: float) -> Dict[str, float]:
    pred = scores > thr
    tp = int((pred & (y == 1)).sum())
    fp = int((pred & (y == 0)).sum())
    fn = int((~pred & (y == 1)).sum())
    return {
        "precision": tp / (tp + fp) if tp + fp else 1.0,
        "recall": tp / (tp + fn) if tp + fn else 1.0,
        "tp": tp, "fp": fp, "fn": fn,
    }


def calibrate_threshold(scores: np.ndarray, y: np.ndarray,
                        target_precision: float = 0.8) -> float:
    """Lowest grid cut whose precision meets the target (most recall at
    acceptable purity); falls back to the most precise cut."""
    best_thr, best_prec = float(THRESHOLD_GRID[-1]), -1.0
    for thr in THRESHOLD_GRID:
        pr = _precision_recall(scores, y, float(thr))
        if pr["tp"] + pr["fp"] == 0:
            continue
        if pr["precision"] >= target_precision:
            return float(thr)
        if pr["precision"] > best_prec:
            best_thr, best_prec = float(thr), pr["precision"]
    return best_thr


def train(corpus_path: str, out_dir: str, *, seed: int = 0,
          hidden: int = 16, steps: int = 400, lr: float = 0.02,
          pos_weight: Optional[float] = None,
          target_precision: float = 0.8, device: str = "cuda") -> Dict:
    """Train from a corpus .npz on ``device``, checkpoint into
    ``out_dir``; returns the metrics/metadata dict (also stored in the
    checkpoint manifest)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.optim.adamw import adamw_init, adamw_update
    from repro_torch.train.loop import TrainConfig

    dev = require_device(device, "train")
    corpus = load_corpus(corpus_path)
    X, y = corpus["X"], corpus["y"].astype(np.float64)
    tr, ev = train_eval_split(len(y), seed=seed)
    if pos_weight is None:
        n_pos = max(float(y[tr].sum()), 1.0)
        pos_weight = float((len(tr) - n_pos) / n_pos)

    # normalization constants from the TRAIN split only (§20: the eval
    # split stands in for unseen scenarios; its moments stay unseen too)
    mu = X[tr].mean(axis=0)
    sd = np.maximum(X[tr].std(axis=0), 1e-6)

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32).to(dev)

    params = init_params(seed, n_features=X.shape[1], hidden=hidden,
                         device=dev)
    params["mu"] = f32(mu)
    params["sd"] = f32(sd)
    frozen = {k: params[k] for k in FROZEN_LEAVES}
    net = {k: params[k] for k in TRAINED_LEAVES}

    tc = TrainConfig(learning_rate=lr, weight_decay=0.01)
    Xtr = f32(X[tr])
    ytr = f32(y[tr])
    w = torch.where(ytr == 1.0, pos_weight, 1.0)

    def loss_fn(net_params):
        z = forward_torch({**net_params, **frozen}, Xtr)
        # weighted BCE-with-logits, the stable max/log1p form
        per = torch.maximum(z, torch.zeros_like(z)) - z * ytr \
            + torch.log1p(torch.exp(-torch.abs(z)))
        return torch.mean(w * per)

    opt = adamw_init(net)
    loss = float("nan")
    for _ in range(steps):
        live = {k: v.detach().requires_grad_(True) for k, v in net.items()}
        value = loss_fn(live)
        grads = dict(zip(live, torch.autograd.grad(value,
                                                   list(live.values()))))
        loss = value.detach()
        net, opt, _m = adamw_update(
            grads, opt, net, lr=tc.lr(), b1=tc.b1, b2=tc.b2,
            weight_decay=tc.weight_decay,
            grad_clip_norm=tc.grad_clip_norm)

    final = {k: v.detach().cpu().numpy().astype(np.float64)
             for k, v in net.items()}
    final["mu"] = np.asarray(mu, dtype=np.float64)
    final["sd"] = np.asarray(sd, dtype=np.float64)

    thr = calibrate_threshold(scores_np(final, X[tr]), y[tr],
                              target_precision=target_precision)
    ev_pr = _precision_recall(scores_np(final, X[ev]), y[ev], thr) \
        if len(ev) else {"precision": 1.0, "recall": 1.0,
                         "tp": 0, "fp": 0, "fn": 0}
    meta = {
        "seed": seed,
        "steps": steps,
        "hidden": hidden,
        "lr": lr,
        "pos_weight": round(float(pos_weight), 6),
        "threshold": thr,
        "final_train_loss": round(float(loss), 6),
        "eval": {k: round(v, 6) if isinstance(v, float) else v
                 for k, v in ev_pr.items()},
        "split": {"seed": seed, "n_train": int(len(tr)),
                  "n_eval": int(len(ev)),
                  "n_pos_train": int(y[tr].sum()),
                  "n_pos_eval": int(y[ev].sum())},
        "feature_names": list(FEATURE_NAMES[:X.shape[1]]),
        "corpus": corpus["meta"],
    }
    mgr = CheckpointManager(out_dir, keep=2)
    mgr.save(final, steps, metadata=meta)
    return meta


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus", default="predict_corpus.npz",
                    help="corpus .npz (generated here if missing)")
    ap.add_argument("--out", default="predict_ckpt")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--no-fleet", action="store_true",
                    help="corpus without the fleet slice (faster)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu; on cpu the corpus "
                         "assesses on numpy")
    args = ap.parse_args(argv)
    if not os.path.exists(args.corpus):
        meta = generate_corpus(
            args.corpus, seed=args.seed, include_fleet=not args.no_fleet,
            assess_backend="numpy" if args.device == "cpu" else None)
        print(f"corpus: {meta['n_rows']} rows "
              f"({meta['n_positive']} positive) -> {args.corpus}")
    meta = train(args.corpus, args.out, seed=args.seed, hidden=args.hidden,
                 steps=args.steps, lr=args.lr, device=args.device)
    print(json.dumps(meta, indent=2, sort_keys=True))


if __name__ == "__main__":
    main()
