"""``chip_smoke.py``'s training phases on the CPU, reduced.

The card's training phase end to end on the plain versions (B1–B4,
B6–B8): the reduced qwen1.5-0.5b through the fault-free run, the loss,
gradient, probe and reproducibility checks, the bino and restart crash
runs and the checkpoint resume, each byte-identical to the fault-free
run. It runs in real time (the restart run waits out a 6 s timeout),
about 20 s. A run that raises (a wedged step) re-raises with every host
and heartbeat thread joined. The family training paths (audio, vlm, moe)
at their reduced configurations: the checks, the launch bookkeeping and
the steps, a few seconds each.
"""
import sys
import threading
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


def _runtime_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith(("host-", "hb-"))]


@pytest.mark.parametrize("wedged_call", [2, 3])
def test_chip_smoke_train_path_joins_hosts_when_a_run_raises(
        chip_smoke, tmp_path, capsys, monkeypatch, wedged_call):
    """A run of the training phase that raises (``StepWedged`` in the
    fault-free run's timed steps, call 2 of ``TrainerRuntime.run``, or in
    the bino crash run, call 3) re-raises after every host thread and
    its heartbeat thread has ended; the fault-free run's heartbeat
    summary is printed first."""
    from repro_torch.runtime import StepWedged, TrainerRuntime

    orig, calls = TrainerRuntime.run, [0]

    def run(self, n_steps, *a, **kw):
        calls[0] += 1
        if calls[0] == wedged_call:
            orig(self, 1)          # the hosts are busy, then the step wedges
            raise StepWedged(self._start_step, "quorum lost (planted)")
        return orig(self, n_steps, *a, **kw)

    monkeypatch.setattr(TrainerRuntime, "run", run)
    cfg = reduced_config(get_config("qwen1.5-0.5b"))
    with pytest.raises(StepWedged, match="planted"):
        chip_smoke.train_path(cfg, device="cpu", steps=2, seq=32,
                              ckpt_root=str(tmp_path))
    assert not _runtime_threads()
    assert "train fault-free: heartbeats " in capsys.readouterr().out
    assert not list(tmp_path.iterdir())       # checkpoints removed


@pytest.mark.parametrize("name,arch", [
    ("audio", "hubert-xlarge"), ("vlm", "internvl2-2b"),
    ("moe", "moonshot-v1-16b-a3b")])
def test_chip_smoke_family_train_path_rehearses_on_cpu(chip_smoke, capsys,
                                                       name, arch):
    """``family_train_path`` at the reduced configuration on the plain
    versions: the gates pass (the probe fails the gradient limit), no
    launch is counted, the plain versions are called."""
    cfg = reduced_config(get_config(arch))
    counts = chip_smoke.family_train_path(name, cfg, device="cpu", steps=2,
                                          seq=32)
    assert not any(counts.values())
    out = capsys.readouterr().out
    assert f"{name} train checks: step 0 loss" in out
    assert "the probe (B8's dq zeroed) 1.0" in out
    assert "leaves differing between two runs []" in out
    assert "AdamW count 3 after 3 steps" in out
    if name == "vlm":
        assert "leaves differing between 'dots' and 'none' {}" in out
