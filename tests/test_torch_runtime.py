"""The port's live training runtime on the CPU: exactly-once gradient
semantics under faults, both recovery strategies, checkpoint restart, and
its losses against the reference's ``TrainerRuntime``.

The runs train reduced qwen1.5-0.5b (float32, 4 layers) on sequences of
32 tokens, 4 hosts x 4 microbatches of 2 sequences, assessing through
``"numpy"`` or ``TorchBackend("cpu")`` (B1–B4's plain versions) — the
card's kernels are the default, and a CPU run names its backend. The
attention runs through B6/B7/B8's plain versions.

1. **Chaos subset** — the pinned crash, hang, drop, dup, cut and
   crash_plus_drop scripts under bino, crash under gang restart, on an
   auto-advancing ``FakeClock`` as the reference's tests run them, until
   every scripted step has fired (and at least ``STEPS`` steps): every
   step fired, final parameters byte-identical to as many fault-free
   steps.
2. **Checkpoint restart** resumes exactly; quorum loss raises
   ``StepWedged``; consecutive ``run`` calls continue the step count.
3. **Against the reference** — from the reference's initial weights
   (``from_jax_params``), the port's per-step losses match the
   reference ``TrainerRuntime``'s within 1e-4 (float32; AdamW's first
   steps move each weight by about ±lr, so the losses stay within float32
   rounding of the gradient sums), its final weights within 2.5·lr
   per step, and each leaf's change over the run within 2 % of the
   reference's in norm (1 when no update is applied, 2 when its sign is
   flipped).
4. **Defaults and clock** — the card is the default device and assessment
   backend (both raise without one), and a runtime whose construction
   raises leaves no host thread running; the copied ``FakeClock`` and
   script parser behave as the reference's.

``chip_smoke.py``'s training phase is rehearsed on the CPU in
``tests/test_torch_train_smoke.py``.
"""
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.runtime import RuntimeConfig as RefRuntimeConfig
from repro.runtime import TrainerRuntime as RefTrainerRuntime
from repro.train.loop import TrainConfig as RefTrainConfig
from repro_torch.accel.torch_backend import TorchBackend
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import layers as L
from repro_torch.models import model as PM
from repro_torch.models.convert import from_jax_params
from repro_torch.obs import K_FAULT, TraceRecorder
from repro_torch.runtime import (ChaosController, FakeClock, RuntimeConfig,
                                 StepWedged, TrainerRuntime)
from repro_torch.runtime.chaos import PINNED_SCRIPTS, parse_script
from repro_torch.train.loop import TrainConfig

ROOT = Path(__file__).resolve().parents[1]
CFG = reduced_config(get_config("qwen1.5-0.5b"))
TC = TrainConfig()
HORIZON = 6.0
STEPS = 3


def _params_vec(trainer):
    return torch.cat([t.detach().reshape(-1) for t in
                      L.tree_leaves(trainer.state["params"]).values()])


def _trainer(recovery="bino", *, script=None, fake_clock=False,
             params=None, assess="numpy", **kw):
    clock = FakeClock(auto_advance=True) if fake_clock else None
    chaos = None
    if script is not None:
        chaos = ChaosController(script, horizon=HORIZON, seed=7)
        # one K_FAULT record a scripted step, at its fire time
        chaos.obs = TraceRecorder(thread_safe=True)
    kw.setdefault("compute_delay", 0.02)
    rt = RuntimeConfig(n_hosts=4, microbatches_per_shard=4,
                       recovery=recovery, assess_backend=assess, **kw)
    return TrainerRuntime(CFG, TC, rt, seq_len=32, per_shard_batch=2, seed=0,
                          clock=clock, chaos=chaos, device="cpu",
                          params=params)


def _run(recovery, steps=STEPS, **kw):
    t = _trainer(recovery, **kw)
    try:
        reports = t.run(steps)
        return _params_vec(t), reports, t.coord
    finally:
        t.shutdown()


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_host():
    """Four host threads each running a tiny model: torch's intra-op
    threads would only contend with each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fault_free():
    """Golden run: real clock, no chaos, assessed by B1–B4's plain
    versions, the columnar/reference differential verified on every
    assessment tick. (The chaos cells assess on numpy: on a FakeClock a
    slower tick lets virtual time run ahead of the hosts.)"""
    vec, reports, _ = _run("bino", verify_columnar=True,
                           assess=TorchBackend("cpu"))
    return vec, reports


@pytest.fixture(scope="module")
def fault_free_at():
    """``at(n)``: the fault-free parameters after ``n`` steps, from one
    run on the real clock assessed on numpy, extended a step at a time
    on demand (a chaos cell runs until its script has fired, so its
    number of steps varies)."""
    t = _trainer()
    vecs = []

    def at(n):
        while len(vecs) < n:
            t.run(1)
            vecs.append(_params_vec(t))
        return vecs[n - 1]
    try:
        yield at
    finally:
        t.shutdown()


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_fault_free_full_work(fault_free):
    _vec, reports = fault_free
    assert [r.step for r in reports] == list(range(STEPS))
    for r in reports:
        assert r.mb_executed >= r.mb_needed == 16
        assert np.isfinite(r.metrics["loss"])


# ---------------------------------------------------------------------------
# 1. Chaos subset: byte-identical to the fault-free run
# ---------------------------------------------------------------------------
CHAOS = [("crash", "bino"), ("hang", "bino"), ("drop", "bino"),
         ("dup", "bino"), ("cut", "bino"), ("crash_plus_drop", "bino"),
         ("crash", "restart")]


def test_fault_free_steps_are_one_run(fault_free, fault_free_at):
    """The chaos cells' golden runs, a step at a time on numpy, end where
    the golden run of ``STEPS`` in one call does."""
    vec_ff, _ = fault_free
    assert torch.equal(vec_ff.view(torch.uint8),
                       fault_free_at(STEPS).view(torch.uint8))


@pytest.mark.parametrize("name,policy", CHAOS,
                         ids=[f"{n}-{p}" for n, p in CHAOS])
def test_chaos_exactly_once(fault_free_at, chip_smoke, name, policy):
    """At least ``STEPS`` steps, and until every step of the script has
    fired and two steps more (``chip_smoke.run_until_fired``; on a fast
    host ``STEPS`` steps can end before a fault fires, ROADMAP.md, C4);
    then byte-identical to as many fault-free steps."""
    script = PINNED_SCRIPTS[name]
    kw = dict(restart_timeout=1.5)
    if policy == "bino":
        kw.update(repair_timeout=0.5, verify_columnar=True)
    t = _trainer(policy, script=script, fake_clock=True, **kw)
    try:
        reports, _fired_at = chip_smoke.run_until_fired(
            lambda: t.run(1), t.coord.chaos, min_steps=STEPS)
        vec = _params_vec(t)
    finally:
        t.shutdown()
    assert chip_smoke.fired_steps(t.coord.chaos) == len(script), \
        f"{name}/{policy}: a scripted fault never fired"
    assert len(reports) >= STEPS
    assert [r.step for r in reports] == list(range(len(reports)))
    for r in reports:
        assert r.mb_executed >= r.mb_needed
    vec_ff = fault_free_at(len(reports))
    assert torch.equal(vec_ff.view(torch.uint8), vec.view(torch.uint8)), \
        f"{name}/{policy}: faulted params diverged from fault-free"
    if name.startswith("crash"):
        # a permanent host loss must surface as an explicit recovery
        assert any(r.recoveries or r.restarts for r in reports)
    if policy == "restart":
        assert sum(r.restarts for r in reports) >= 1
        assert sum(r.mb_executed for r in reports) > \
            sum(r.mb_needed for r in reports)


# ---------------------------------------------------------------------------
# 2. Checkpoints, quorum, step numbering
# ---------------------------------------------------------------------------
def test_checkpoint_restart_resumes_exactly(tmp_path, fault_free):
    vec_ff, _ = fault_free
    kw = dict(checkpoint_dir=str(tmp_path), checkpoint_every=2)
    t1 = _trainer(**kw)
    try:
        t1.run(2)  # checkpoint at step 2
    finally:
        t1.shutdown()
    # "crash" the coordinator; a fresh trainer restores step 2 and finishes
    t2 = _trainer(**kw)
    try:
        assert t2._start_step == 2
        reports = t2.run(1)
        vec = _params_vec(t2)
    finally:
        t2.shutdown()
    assert [r.step for r in reports] == [2]
    assert torch.equal(vec_ff.view(torch.uint8), vec.view(torch.uint8))


def test_consecutive_runs_continue_the_step_count(fault_free):
    vec_ff, _ = fault_free
    t = _trainer()
    try:
        reports = t.run(1) + t.run(STEPS - 1)
        vec = _params_vec(t)
    finally:
        t.shutdown()
    assert [r.step for r in reports] == list(range(STEPS))
    assert torch.equal(vec_ff.view(torch.uint8), vec.view(torch.uint8))


def test_quorum_loss_raises_step_wedged():
    """Losing 3 of 4 hosts drops below quorum; the step rolls back, retries
    on the survivors, then surfaces StepWedged (no silent hang)."""
    script = [("crash", 1, 0.0, 0.0), ("crash", 2, 0.0, 0.0),
              ("crash", 3, 0.0, 0.0)]
    t = _trainer(script=script, fake_clock=True, step_retry_limit=1,
                 repair_timeout=0.5, step_deadline=20.0)
    try:
        with pytest.raises(StepWedged):
            t.run(2)
    finally:
        t.shutdown()
    fired = t.coord.chaos.obs.by_kind(K_FAULT)
    assert sorted(fired["a"].tolist()) == [1, 2, 3], "a crash never fired"


# ---------------------------------------------------------------------------
# 3. Against the reference's TrainerRuntime
# ---------------------------------------------------------------------------
def test_losses_match_reference_runtime():
    rcfg = ref_reduced_config(ref_get_config("qwen1.5-0.5b"))
    rrt = RefRuntimeConfig(n_hosts=4, microbatches_per_shard=4,
                           recovery="bino", compute_delay=0.0)
    ref = RefTrainerRuntime(rcfg, RefTrainConfig(), rrt, seq_len=32,
                            per_shard_batch=2, seed=0)
    try:
        params0 = jax.tree.map(np.asarray, ref.state["params"])
        ref_reports = ref.run(STEPS)
        ref_final = jax.tree.map(np.asarray, ref.state["params"])
    finally:
        ref.shutdown()
    start = L.tree_leaves(from_jax_params(CFG, params0, device="cpu"))
    port = _trainer(params=from_jax_params(CFG, params0, device="cpu"),
                    compute_delay=0.0)
    try:
        reports = port.run(STEPS)
        final = L.tree_leaves(port.state["params"])
    finally:
        port.shutdown()
    np.testing.assert_allclose([r.metrics["loss"] for r in reports],
                               [r.metrics["loss"] for r in ref_reports],
                               rtol=1e-4)
    want = L.tree_leaves(from_jax_params(CFG, ref_final, device="cpu"))
    worst = max(float((final[k].detach() - want[k]).abs().max())
                for k in want)
    assert worst <= 2.5 * TC.learning_rate * STEPS, worst
    # ||Δ_port - Δ_ref|| / ||Δ_ref|| per leaf, Δ = final - initial weights
    # (0.0029 at most in float32, a K bias)
    moved = {k: float(((final[k].detach() - start[k]) - (want[k] - start[k]))
                      .norm() / (want[k] - start[k]).norm()) for k in want}
    assert max(moved.values()) <= 0.02, moved


# ---------------------------------------------------------------------------
# 4. Defaults and the clock
# ---------------------------------------------------------------------------
def test_defaults_are_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainerRuntime(CFG, TC, RuntimeConfig(assess_backend="numpy"))
    params = PM.init_params(CFG, 0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainerRuntime(CFG, TC, RuntimeConfig(), params=params)


def _host_threads():
    return {t for t in threading.enumerate()
            if t.name.startswith(("host-", "hb-")) and t.is_alive()}


@pytest.mark.parametrize("fault", ["no_card", "chaos_arm"])
def test_failed_construction_leaves_no_host_thread(fault, monkeypatch):
    """A runtime whose construction raises leaves no host or heartbeat
    thread running: without a card the default assessment backend raises
    before any host starts; a failure after the hosts have started (here
    the chaos controller's arming) stops and joins them."""
    before = _host_threads()
    params = PM.init_params(CFG, 0, device="cpu")
    if fault == "no_card":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TrainerRuntime(CFG, TC, RuntimeConfig(), params=params)
    else:
        chaos = ChaosController([], horizon=HORIZON, seed=7)

        def arm(hosts, clock):
            assert set(hosts.values()) <= _host_threads()
            raise RuntimeError("arm failed")
        chaos.arm = arm
        with pytest.raises(RuntimeError, match="arm failed"):
            TrainerRuntime(CFG, TC, RuntimeConfig(assess_backend="numpy"),
                           params=params, chaos=chaos)
    assert not _host_threads() - before


def test_fake_clock_manual_advance_is_deterministic():
    clk = FakeClock(start=1000.0)
    woke = []

    def sleeper():
        clk.sleep(5.0)
        woke.append(clk.time())

    th = threading.Thread(target=sleeper, daemon=True)
    th.start()
    deadline = time.time() + 2.0
    while not clk._waiters and time.time() < deadline:
        time.sleep(0.001)
    clk.advance(4.9)
    time.sleep(0.05)
    assert not woke, "sleeper woke before its deadline"
    clk.advance(0.2)
    th.join(timeout=2.0)
    assert woke and woke[0] == pytest.approx(1005.1)
    clk.close()


def test_fake_clock_auto_advance_jumps_to_deadline():
    clk = FakeClock(start=0.0, auto_advance=True)
    t0 = time.time()
    clk.sleep(30.0)  # half a real minute, virtually
    assert time.time() - t0 < 5.0
    assert clk.time() >= 30.0
    clk.close()


def test_parse_script_named_and_inline():
    assert parse_script("crash") == PINNED_SCRIPTS["crash"]
    assert parse_script("cut:1:0.25:0.5,dup:0:0:0.9") == \
        [("cut", 1, 0.25, 0.5), ("dup", 0, 0.0, 0.9)]

