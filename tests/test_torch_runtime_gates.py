"""``chip_smoke.py``'s runtime gates, on the CPU.

1. ``run_until_fired`` — the loop that runs a training world until every
   scripted fault has fired (ROADMAP.md, C4): at least ``min_steps``
   steps, ``after`` steps past the last fired step, and a raise at the
   cap.
2. The sim ≡ runtime gate (``scorecard_gate``, fig_scorecard's) with
   assessment on ``TorchBackend("cpu")`` at the reference gate's sizes:
   it holds for both scripts; a script that never fires makes it raise.
3. The recovery gate (``recovery_gate``, perf_runtime's) on the CPU, in
   a child process through the card's entry (``runtime_child``), its
   constants those of ``benchmarks/perf_runtime.py``: bino recovers
   before gang restart, both runs end on the fault-free run's bytes.
4. The gates' constants against the reference's benchmarks and tests.
"""
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.accel.torch_backend import TorchBackend
from repro_torch.obs import K_FAULT, TraceRecorder

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)     # four host threads, a tiny model
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# 1. run_until_fired
# ---------------------------------------------------------------------------
class _Script:
    """A stand-in controller whose scripted steps fire at given training
    steps (1-based), recorded as the controller records them."""

    def __init__(self, fire_at):
        self.script = [("crash", i, 0.0, 0.0) for i in range(len(fire_at))]
        self.obs = TraceRecorder()
        self.fire_at = fire_at
        self.steps = 0

    def step(self):
        self.steps += 1
        for i, at in enumerate(self.fire_at):
            if at == self.steps:
                self.obs.emit(K_FAULT, a=i, b=1)
        return [self.steps]


@pytest.mark.parametrize("fire_at,min_steps,want", [
    ((1,), 3, (3, 1)),          # fired early: the reference's 3 steps
    ((5,), 3, (7, 5)),          # fired late: two steps after it
    ((2, 9), 3, (11, 9)),       # the last step counts
    ((), 3, (3, 1)),            # nothing scripted
])
def test_run_until_fired_steps(chip_smoke, fire_at, min_steps, want):
    ctl = _Script(fire_at)
    reports, fired_at = chip_smoke.run_until_fired(ctl.step, ctl,
                                                   min_steps=min_steps)
    assert (len(reports), fired_at) == want
    assert reports == list(range(1, want[0] + 1))
    assert chip_smoke.fired_steps(ctl) == len(fire_at)


def test_run_until_fired_raises_at_the_cap(chip_smoke):
    ctl = _Script((1, 50))
    with pytest.raises(RuntimeError, match="1 of the script's 2 steps "
                                           "fired in 12 training steps"):
        chip_smoke.run_until_fired(ctl.step, ctl, cap=12)
    assert ctl.steps == 12


# ---------------------------------------------------------------------------
# 2. The sim ≡ runtime gate
# ---------------------------------------------------------------------------
def test_scorecard_gate_on_cpu(chip_smoke, one_thread, capsys):
    total = chip_smoke.scorecard_gate("cpu", TorchBackend("cpu"),
                                      TorchBackend("cpu"))
    assert not any(total.values())      # plain versions: no launch
    out = capsys.readouterr().out
    for name in chip_smoke.CROSS_SCRIPTS:
        assert f"sim ≡ runtime {name}: " in out


def test_scorecard_gate_raises_when_a_script_never_fires(chip_smoke,
                                                         one_thread):
    """A crash 300 virtual seconds after arming: the runtime world ends
    at the cap with nothing fired, and the gate raises instead of
    comparing an empty scorecard."""
    with pytest.raises(RuntimeError, match="0 of the script's 1 steps"):
        chip_smoke.scorecard_gate(
            "cpu", "numpy", "numpy",
            scripts={"never": [("crash", 1, 50.0, 0.0)]}, cap=6)


# ---------------------------------------------------------------------------
# 3. The recovery gate
# ---------------------------------------------------------------------------
def test_recovery_gate_on_cpu(chip_smoke, capsys):
    """The gate through the entry the card's run takes: a fresh child
    process that freezes each run's objects during its steps
    (``runtime_child``), on ``TorchBackend("cpu")``. In this test's
    process the real-clock steps shared their collections with the
    worker's earlier files (ROADMAP.md, C7); a failure carries the
    child's lines, so it names its raise."""
    total = chip_smoke.runtime_child("cpu", ("recovery",), n_meas=4)
    assert list(total) == ["recovery"]
    assert not any(total["recovery"].values())
    out = capsys.readouterr().out
    assert out.count("byte-identical to the fault-free run") == 2
    assert "recovery gate: bino " in out


# ---------------------------------------------------------------------------
# 4. The constants
# ---------------------------------------------------------------------------
def test_gate_constants_are_the_reference_benchmarks(chip_smoke):
    from benchmarks import fig_scorecard, perf_runtime
    from test_obs import CROSS_SCRIPTS

    assert chip_smoke.CROSS_SCRIPTS == fig_scorecard.SCRIPTS
    assert list(chip_smoke.CROSS_SCRIPTS.values()) == CROSS_SCRIPTS
    assert chip_smoke.RUNTIME_HOSTS == fig_scorecard.N_WORKERS \
        == perf_runtime.HOSTS
    assert (chip_smoke.RUNTIME_MB, chip_smoke.RUNTIME_SEQ,
            chip_smoke.RECOVERY_DELAY, chip_smoke.RECOVERY_WARMUP,
            chip_smoke.RECOVERY_SCRIPT, chip_smoke.RECOVERY_HORIZON,
            chip_smoke.RESTART_TIMEOUT, chip_smoke.REPAIR_TIMEOUT) == (
        perf_runtime.MICROBATCHES, perf_runtime.SEQ_LEN,
        perf_runtime.COMPUTE_DELAY, perf_runtime.WARMUP_STEPS,
        perf_runtime.CRASH_SCRIPT, perf_runtime.CHAOS_HORIZON,
        perf_runtime.RESTART_TIMEOUT, perf_runtime.REPAIR_TIMEOUT)
