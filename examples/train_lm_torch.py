"""End-to-end training driver with binocular-speculation fault recovery,
on the PyTorch/CUDA port.

Trains a registry architecture over the thread-simulated multi-host
runtime: microbatch map tasks stream gradients to the coordinator, the
speculator (Bino or the gang-restart baseline) handles injected host
crashes/stragglers, checkpoints commit atomically, and a killed run
resumes from the newest checkpoint + data-pipeline state. The flags and
printed lines are ``examples/train_lm.py``'s.

The host threads compute gradients on the CUDA card by default (attention
through the hand-written kernels B6 forward and B7/B8 backward) and the
coordinator's bino ticks assess there (B1–B4); ``--device cpu`` runs both
on the CPU (the kernels' plain versions). Without ``--device cpu`` the
run needs a card and raises where there is none.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 30 \\
        --freeze-host h02@8 --slow-host h01@15x0.2 --recovery bino

``--full`` trains the production config at full width (Qwen1.5-0.5B by
default, bf16 weights: B6–B8 on their Hopper bodies at head_dim 64):

    PYTHONPATH=src python examples/train_lm_torch.py --full --steps 6 \\
        --freeze-host h02@3
"""
from __future__ import annotations

import argparse
import threading

from repro_torch.accel.torch_backend import TorchBackend, require_device
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.runtime import RuntimeConfig, TrainerRuntime
from repro_torch.train.loop import TrainConfig


def parse_faults(spec_list, kind):
    out = []
    for spec in spec_list or []:
        if kind == "freeze":        # h02@8
            host, step = spec.split("@")
            out.append((host, int(step), None))
        else:                        # h01@15x0.2
            host, rest = spec.split("@")
            step, factor = rest.split("x")
            out.append((host, int(step), float(factor)))
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=ARCH_IDS)
    ap.add_argument("--full", action="store_true",
                    help="use the full production config (slow on CPU)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--hosts", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--recovery", default="bino",
                    choices=["bino", "restart"])
    ap.add_argument("--freeze-host", action="append",
                    help="host@step, e.g. h02@8 (crash)")
    ap.add_argument("--slow-host", action="append",
                    help="host@stepxfactor, e.g. h01@15x0.2 (straggler)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of the weights, the gradients and the "
                         "assessment (default: the CUDA card)")
    args = ap.parse_args(argv)
    require_device(args.device, "train_lm_torch")
    return args


def make_trainer(args: argparse.Namespace) -> TrainerRuntime:
    """The runtime that ``main`` trains, from its parsed flags."""
    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced_config(cfg)
    rt = RuntimeConfig(
        n_hosts=args.hosts, microbatches_per_shard=args.microbatches,
        recovery=args.recovery, compute_delay=0.02,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        assess_backend=TorchBackend(args.device))
    return TrainerRuntime(cfg, TrainConfig(), rt, seq_len=args.seq_len,
                          per_shard_batch=2, device=args.device)


def main(argv=None) -> int:
    args = parse_args(argv)
    trainer = make_trainer(args)

    freezes = parse_faults(args.freeze_host, "freeze")
    slows = parse_faults(args.slow_host, "slow")

    def on_step(step, tr):
        for host, s, _ in freezes:
            if s == step:
                print(f"  !! injecting crash of {host} during step {step}")
                threading.Timer(0.05, lambda h=host: tr.freeze_host(h)).start()
        for host, s, f in slows:
            if s == step:
                print(f"  !! slowing {host} by {f}x from step {step}")
                tr.slow_host(host, 1.0 / f)

    try:
        reports = trainer.run(args.steps, on_step=on_step)
        for r in reports:
            line = (f"step {r.step:4d}  loss {r.metrics.get('loss', float('nan')):7.3f}  "
                    f"wall {r.wall_s:6.2f}s  mb {r.mb_executed}/{r.mb_needed}")
            if r.restarts:
                line += f"  restarts={r.restarts}"
            for rec in r.recoveries:
                line += f"\n      recovery: {rec}"
            print(line)
        waste = sum(r.mb_executed - r.mb_needed for r in reports)
        total = sum(r.mb_needed for r in reports)
        print(f"\ndone: {args.steps} steps, {waste} wasted microbatch "
              f"executions / {total} needed "
              f"({100.0 * waste / max(total, 1):.1f}% overhead)")
    finally:
        trainer.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
