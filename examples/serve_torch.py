"""Chaos-hardened runtime demo on the PyTorch/CUDA port: drive the live
coordinator under a declarative fault script and validate every
committed model update.

Runs the same control plane as ``examples/train_lm_torch.py`` but
against the chaos plane (DESIGN.md §16): pick a recovery policy, pick a
fault script (a named pinned script or an inline ``kind:victim:x:y,...``
spec — the same vocabulary ``sim/faults.py`` interprets), and the
process exits non-zero if any committed update is corrupted (non-finite
parameters or loss) or a step wedges past its retries. The flags,
printed lines and exit codes are ``examples/serve.py``'s.

The host threads compute gradients on the CUDA card by default (B6–B8)
and the coordinator's bino ticks assess there (B1–B4); ``--device cpu``
runs both on the CPU (the kernels' plain versions). Without ``--device
cpu`` the run needs a card and raises where there is none.

    PYTHONPATH=src python examples/serve_torch.py --policy bino --chaos crash
    PYTHONPATH=src python examples/serve_torch.py --policy restart \\
        --chaos "drop:1:0.1:0.5,dup:0:0.05:0.9" --steps 6

Exit codes: 0 ok, 2 corrupted model update, 3 wedged (retries exhausted).
"""
from __future__ import annotations

import argparse
import math
import sys

import torch

from repro_torch.accel.torch_backend import TorchBackend, require_device
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.models import layers as L
from repro_torch.runtime import (
    ChaosController,
    RuntimeConfig,
    StepWedged,
    TrainerRuntime,
    parse_script,
)
from repro_torch.runtime.chaos import PINNED_SCRIPTS
from repro_torch.train.loop import TrainConfig


def _update_corrupted(trainer) -> bool:
    for leaf in L.tree_leaves(trainer.state["params"]).values():
        if not bool(torch.isfinite(leaf).all()):
            return True
    return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--hosts", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--policy", default="bino", choices=["bino", "restart"])
    ap.add_argument("--chaos", default=None, metavar="SCRIPT",
                    help="named pinned script (%s) or inline "
                         "kind:victim:x:y[,...]" % ", ".join(PINNED_SCRIPTS))
    ap.add_argument("--horizon", type=float, default=20.0,
                    help="chaos horizon in seconds (x/y map into it)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record the run with the flight recorder and "
                         "export a Chrome/Perfetto trace (DESIGN.md §18; "
                         "see examples/TRACES.md)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of the weights, the gradients and the "
                         "assessment (default: the CUDA card)")
    args = ap.parse_args(argv)
    require_device(args.device, "serve_torch")

    cfg = reduced_config(get_config(args.arch))
    chaos = (ChaosController(parse_script(args.chaos),
                             horizon=args.horizon, seed=args.seed)
             if args.chaos else None)
    recorder = None
    if args.trace:
        from repro_torch.obs import TraceRecorder
        # chaos emits fault markers from its own scheduler thread
        recorder = TraceRecorder(thread_safe=True)
    rt = RuntimeConfig(
        n_hosts=args.hosts, microbatches_per_shard=args.microbatches,
        recovery=args.policy, compute_delay=0.02,
        repair_timeout=1.0, restart_timeout=3.0,
        assess_backend=TorchBackend(args.device))
    trainer = TrainerRuntime(cfg, TrainConfig(), rt,
                             seq_len=args.seq_len, per_shard_batch=2,
                             seed=args.seed, chaos=chaos, obs=recorder,
                             device=args.device)
    print(f"policy={args.policy} hosts={args.hosts} "
          f"chaos={args.chaos or 'none'}")
    try:
        try:
            reports = trainer.run(args.steps)
        except StepWedged as e:
            print(f"FATAL: step {e.step} wedged past retry limit",
                  file=sys.stderr)
            return 3
        bad = False
        for r in reports:
            loss = float(r.metrics.get("loss", float("nan")))
            line = (f"step {r.step:3d}  loss {loss:7.3f}  "
                    f"wall {r.wall_s:6.2f}s  mb {r.mb_executed}/{r.mb_needed}")
            if r.restarts:
                line += f"  restarts={r.restarts}"
            if r.wedges:
                line += f"  wedges={r.wedges}"
            for rec in r.recoveries:
                line += f"\n      recovery: {rec}"
            print(line)
            if not math.isfinite(loss):
                bad = True
        if chaos is not None:
            active = {k: v for k, v in chaos.stats.items() if v}
            print(f"chaos stats: {active or 'no events fired'}")
        if recorder is not None:
            from repro_torch.obs import scorecard, write_chrome_trace
            hosts = [f"h{i:02d}" for i in range(args.hosts)]
            path = write_chrome_trace(recorder, args.trace,
                                      node_names=hosts)
            card = scorecard(recorder, policy=args.policy)
            print(f"trace: {len(recorder)} records "
                  f"({recorder.dropped} dropped) -> {path} "
                  f"(open in https://ui.perfetto.dev)")
            if chaos is not None:
                print(f"scorecard: recall={card['recall']} "
                      f"precision={card['precision']} ttd={card['ttd']}")
        if bad or _update_corrupted(trainer):
            print("FATAL: corrupted model update detected", file=sys.stderr)
            return 2
        print("ok: all committed updates finite")
        return 0
    finally:
        trainer.shutdown()


if __name__ == "__main__":
    sys.exit(main())
