"""``chip_smoke.py``'s training phase on the CPU, reduced.

The card's phase end to end on the plain versions (B1–B4, B6–B8): the
reduced qwen1.5-0.5b through the fault-free run, the loss, gradient,
probe and reproducibility checks, the bino and restart crash runs and the
checkpoint resume, each byte-identical to the fault-free run. It runs in
real time (the restart run waits out a 6 s timeout), about 20 s.
"""
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config, reduced_config

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    n = torch.get_num_threads()
    torch.set_num_threads(1)     # four host threads, a tiny model
    yield chip_smoke
    torch.set_num_threads(n)


def test_chip_smoke_train_path_rehearses_on_cpu(chip_smoke, tmp_path,
                                                capsys):
    cfg = reduced_config(get_config("qwen1.5-0.5b"))
    counts = chip_smoke.train_path(cfg, device="cpu", steps=2, seq=32,
                                   ckpt_root=str(tmp_path))
    assert not any(counts.values())           # plain versions: no launch
    out = capsys.readouterr().out
    assert "the probe (B8's dq zeroed) 1.0" in out
    for run in ("bino crash", "restart crash"):
        assert f"train {run} (horizon" in out
    assert out.count("byte-identical to the fault-free run") == 3
    assert not list(tmp_path.iterdir())       # checkpoints removed


def test_chip_smoke_train_wall_rehearses_on_cpu(chip_smoke, capsys):
    """``--train-wall``'s fault-free run on the CPU: every host's
    heartbeat silences timed, the run's outcome and the collector's
    pauses printed."""
    cfg = reduced_config(get_config("qwen1.5-0.5b"))
    chip_smoke.train_wall(cfg, device="cpu", seq=32, steps=2, runs=1)
    out = capsys.readouterr().out
    line = out.split("train wall ")[1]
    assert " run 0: ok; step walls " in line
    assert all(f"'h0{i}'" in line for i in range(4))
    assert "over 1 s" in line and "garbage collections" in line
