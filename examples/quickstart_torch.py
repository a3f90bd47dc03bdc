"""Quickstart on the PyTorch/CUDA port: build any assigned architecture,
run one train step and one decode step, and print the loss and the
logits' shape. The flags and printed lines are ``examples/quickstart.py``'s.

The reduced twin runs on the CUDA card by default (attention through the
hand-written kernels B6–B9, the Mamba-2 scan through B10), its first call
building or loading the kernels; ``--device cpu`` runs the kernels' plain
versions on the CPU. Without ``--device cpu`` the run needs a card and
raises where there is none.

    PYTHONPATH=src python examples/quickstart_torch.py --arch qwen3-8b
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.accel.torch_backend import require_device
from repro_torch.configs import (
    ARCH_IDS, REDUCED_SHAPE_TRAIN, get_config, reduced_config)
from repro_torch.models import model as MODEL
from repro_torch.models.inputs import input_specs, materialize
from repro_torch.train.loop import (
    TrainConfig, make_serve_step, make_train_step, train_state_init)


def _wall(t0: float, dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.time() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=ARCH_IDS)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of the reduced twin (default: the CUDA "
                         "card)")
    args = ap.parse_args(argv)
    dev = require_device(args.device, "quickstart_torch")
    where = "CPU" if dev.type == "cpu" else "the CUDA card"
    first = ("first call" if dev.type == "cpu"
             else "first call, incl. building or loading the kernels")

    full = get_config(args.arch)
    cfg = reduced_config(full)  # CPU-sized twin of the same family
    n_total, n_active = full.param_counts()
    print(f"[{args.arch}] family={full.family} "
          f"params={n_total/1e9:.2f}B (active {n_active/1e9:.2f}B); "
          f"running the reduced twin on {where}")

    tc = TrainConfig()
    state = train_state_init(cfg, 0, tc, device=args.device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    batch = materialize(input_specs(cfg, REDUCED_SHAPE_TRAIN), gen,
                        cfg.vocab_size)

    train_step = make_train_step(cfg, tc)
    t0 = time.time()
    state, metrics = train_step(state, batch)
    print(f"train step: loss={float(metrics['loss']):.3f} "
          f"grad_norm={float(metrics['grad_norm']):.3f} "
          f"({_wall(t0, dev):.1f}s {first})")

    if not cfg.is_encoder_only():
        serve = make_serve_step(cfg, tc)
        cache = MODEL.init_cache(cfg, batch=2, max_len=64, device=dev)
        tokens = torch.tensor([1, 2], dtype=torch.int32, device=dev)
        pos = torch.zeros((2,), dtype=torch.int32, device=dev)
        t0 = time.time()
        logits, cache = serve(state["params"], cache, tokens, pos)
        print(f"decode step: logits {tuple(logits.shape)} "
              f"({_wall(t0, dev):.1f}s {first})")
    print("ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
