"""The port's flight-recorder exporters and scorecards against the
reference package's (``repro_torch.obs.export``, ``.scorecard``).

1. **Exporters** — the same seeded, traced simulation in both packages
   (the port assessing on ``"numpy"``): ``to_chrome_trace`` gives the same
   JSON document from the port's function on the port's recorder as from
   the reference's on the reference's, the two recorders diff as equal
   record for record, and ``trace_diff`` reports the same verdicts.
2. **Scorecards** — ``attempt_outcomes``, ``scorecard`` (both modes) and
   ``comparable_core`` equal for bino and yarn over
   ``tests/test_obs.py``'s scripts, and the reference's scorecard math
   cases on hand-built traces.
3. **Cross-world identity** — ``tests/test_obs.py``'s gate on the port
   alone: the port's simulator and the port's ``TrainerRuntime`` (reduced
   qwen1.5-0.5b on a ``FakeClock``, ``device="cpu"``, assessing on
   numpy), fed the same fault script, give scorecards with the same
   comparable core. The runtime world runs until every scripted step has
   fired, then two steps more, and fails if a step never fires; the same
   world of the reference's ``TrainerRuntime`` gives the same core.
"""
import json
import sys
from pathlib import Path

import pytest
import torch

import repro.obs as R
import repro.sim as ref_sim
import repro_torch.obs as P
import repro_torch.sim as port_sim
from repro_torch.accel.torch_backend import TorchBackend

ROOT = Path(__file__).resolve().parents[1]
SHUFFLES = ("rescan", "event", "batch", "kernel")
# tests/test_obs.py's scripts: (name, policy, seed, script)
OBS_SCENARIOS = [
    ("crash_during_shuffle", "bino", 3, [("crash", 7, 0.45, 0.0)]),
    ("mof_plus_slowdown", "bino", 2,
     [("mof", 0, 0.85, 1.0), ("slow", 4, 0.3, 0.2)]),
    ("yarn_crash_mid_map", "yarn", 1, [("crash", 3, 0.15, 0.0)]),
]


def _traced(pkg, obs, policy, seed, script, mode="batch", **kw):
    """One seeded 1 GB terasort under ``script``, recorded into ``obs``."""
    sim = pkg.Simulation(policy=policy, seed=seed, shuffle=mode, obs=obs,
                         **kw)
    job = sim.submit(pkg.JobSpec("j0", "terasort", 1.0))
    pkg.faults.apply_script(sim, job, script)
    sim.run()
    return sim


def _pair(policy, seed, script, mode="batch", port_backend="numpy"):
    """(port recorder, reference recorder) of one run."""
    port = P.TraceRecorder()
    _traced(port_sim, port, policy, seed, script, mode,
            assess_backend=port_backend)
    ref = R.TraceRecorder()
    _traced(ref_sim, ref, policy, seed, script, mode)
    return port, ref


# ---------------------------------------------------------------------------
# 1. Exporters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["numpy", "torch-cpu"])
def test_chrome_trace_equals_reference(backend, tmp_path):
    port, ref = _pair("bino", 3, [("crash", 7, 0.45, 0.0)],
                      port_backend=(TorchBackend("cpu")
                                    if backend == "torch-cpu" else "numpy"))
    assert len(port) > 0 and len(port) == len(ref)
    got = json.dumps(P.to_chrome_trace(port), sort_keys=True)
    want = json.dumps(R.to_chrome_trace(ref), sort_keys=True)
    assert got == want
    # the file writer, and node names as track names
    names = [f"n{i:02d}" for i in range(20)]
    P.write_chrome_trace(port, str(tmp_path / "p.json"), node_names=names)
    R.write_chrome_trace(ref, str(tmp_path / "r.json"), node_names=names)
    assert (tmp_path / "p.json").read_text() == \
        (tmp_path / "r.json").read_text()


def test_trace_diff_equals_reference():
    port, ref = _pair("bino", 3, [("crash", 7, 0.45, 0.0)])
    # the two packages' recorders, record for record
    d = P.trace_diff(port, ref)
    assert d["equal"], d
    assert d == R.trace_diff(ref, port)
    # a diverging pair: both report the same first difference
    port2, ref2 = _pair("bino", 2, [("crash", 7, 0.45, 0.0)])
    got, want = P.trace_diff(port, port2), R.trace_diff(ref, ref2)
    assert not got["equal"] and got == want
    kinds = [P.K_ACTION, P.K_DETECT]
    assert P.trace_diff(port, port2, kinds=kinds) == \
        R.trace_diff(ref, ref2, kinds=kinds)
    assert P.trace_diff(port, port2, time_tol=1e9) == \
        R.trace_diff(ref, ref2, time_tol=1e9)


def test_trace_diff_hand_built():
    t = [1.0]
    for pkg in (P, R):
        a, b, c = (pkg.TraceRecorder(lambda: t[0]) for _ in range(3))
        a.emit(pkg.K_DETECT, a=1, b=1)
        for rec in (b, c):
            rec.emit(pkg.K_DETECT, a=2, b=1)
        b.emit(pkg.K_DETECT, a=2, b=1)
        d = pkg.trace_diff(a, b)
        assert not d["equal"] and d["first_diff"] == 0 and "a=" in d["detail"]
        assert pkg.trace_diff(a, a)["equal"]
        d = pkg.trace_diff(b, c)
        assert not d["equal"] and d["first_diff"] is None
        assert d["detail"] == "length mismatch: 2 vs 1"


# ---------------------------------------------------------------------------
# 2. Scorecards
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,policy,seed,script", OBS_SCENARIOS,
                         ids=[s[0] for s in OBS_SCENARIOS])
def test_scorecards_equal_reference(name, policy, seed, script):
    port, ref = _pair(policy, seed, script)
    assert P.attempt_outcomes(port) == R.attempt_outcomes(ref)
    for mode in ("mark", "any"):
        got = P.scorecard(port, policy=policy, mode=mode)
        assert got == R.scorecard(ref, policy=policy, mode=mode)
        assert P.comparable_core(got) == R.comparable_core(got)


@pytest.mark.parametrize("mode", SHUFFLES)
def test_scorecard_equal_reference_across_engines(mode):
    name, policy, seed, script = OBS_SCENARIOS[0]
    port, ref = _pair(policy, seed, script, mode=mode)
    assert P.trace_diff(port, ref)["equal"]
    assert P.scorecard(port, policy=policy, mode="any") == \
        R.scorecard(ref, policy=policy, mode="any")


def _hand_trace(pkg):
    """tests/test_obs.py's hand-built ground truth, in ``pkg``."""
    t = [0.0]
    rec = pkg.TraceRecorder(lambda: t[0])
    t[0] = 5.0
    rec.emit(pkg.K_FAULT, a=1, b=pkg.FAULT_CODES["crash"])      # victim 1
    rec.emit(pkg.K_FAULT, a=-1, b=pkg.FAULT_CODES["mof"])       # not a node
    t[0] = 6.5
    rec.emit(pkg.K_DETECT, a=1, b=1)                            # tp, ttd 1.5
    t[0] = 7.0
    rec.emit(pkg.K_DETECT, a=3, b=0)                            # fp
    t[0] = 8.0
    rec.emit(pkg.K_FAULT, a=2, b=pkg.FAULT_CODES["hang"])       # fn
    rec.emit(pkg.K_ATT_END, a=1, b=pkg.END_FAILED, f1=3.5, f2=1.0)
    rec.emit(pkg.K_ATT_END, a=0, b=pkg.END_COMPLETED, f1=2.0, f2=1.0)
    rec.emit(pkg.K_ATT_END, a=0, b=pkg.END_FAILED, f1=9.0, f2=0.0)
    return rec


def test_scorecard_math():
    card = P.scorecard(_hand_trace(P), policy="hand")
    assert card["victims"] == [1, 2]
    assert card["tp"] == [1] and card["fp"] == [3] and card["fn"] == [2]
    assert card["precision"] == 0.5 and card["recall"] == 0.5
    assert card["ttd"] == {1: 1.5} and card["mean_ttd"] == 1.5
    assert card["n_backups"] == 2
    assert card["wasted_backup_work"] == 3.5
    assert P.comparable_core(card) == {
        "victims": [1, 2], "tp": [1], "fp": [3], "fn": [2],
        "precision": 0.5, "recall": 0.5}
    for mode in ("mark", "any"):
        assert P.scorecard(_hand_trace(P), policy="hand", mode=mode) == \
            R.scorecard(_hand_trace(R), policy="hand", mode=mode)
    assert P.attempt_outcomes(_hand_trace(P)) == \
        R.attempt_outcomes(_hand_trace(R))


def test_scorecard_vacuous_cases():
    card = P.scorecard(P.TraceRecorder())
    assert card["precision"] == 1.0 and card["recall"] == 1.0
    assert card["victims"] == [] and card["mean_ttd"] is None
    assert card == R.scorecard(R.TraceRecorder())
    with pytest.raises(ValueError):
        P.scorecard(P.TraceRecorder(), mode="nope")


# ---------------------------------------------------------------------------
# 3. Cross-world identity: the port's simulator vs the port's runtime
# ---------------------------------------------------------------------------
CROSS_SCRIPTS = [
    [("crash", 1, 0.2, 0.0)],
    [("crash", 1, 0.2, 0.0), ("crash", 2, 0.3, 0.0)],
]
CROSS_IDS = ["one_crash", "two_crashes"]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)     # four host threads, a tiny model
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def _port_runtime_world(chip_smoke, script):
    """The port's ``TrainerRuntime`` (reduced qwen1.5-0.5b on a
    ``FakeClock``, ``device="cpu"``, assessing on numpy) under
    ``script``, run until every scripted step has fired and then two
    steps more (``chip_smoke.run_until_fired``): the reference gate's
    ``t.run(3)`` can end before its crash fires on a fast host
    (ROADMAP.md, C4). Returns the recorder, the metrics snapshot and the
    scripted steps fired."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.runtime import (ChaosController, FakeClock,
                                     RuntimeConfig, TrainerRuntime)
    from repro_torch.train.loop import TrainConfig

    rec = P.TraceRecorder(thread_safe=True)
    rt = RuntimeConfig(n_hosts=4, microbatches_per_shard=4,
                       recovery="bino", compute_delay=0.02,
                       assess_backend="numpy")
    chaos = ChaosController(script, horizon=6.0, seed=7)
    t = TrainerRuntime(
        reduced_config(get_config("qwen1.5-0.5b")), TrainConfig(), rt,
        seq_len=32, per_shard_batch=2, seed=0,
        clock=FakeClock(auto_advance=True), chaos=chaos, obs=rec,
        device="cpu")
    try:
        chip_smoke.run_until_fired(lambda: t.run(1), chaos)
        snap = t.coord.metrics.snapshot()
    finally:
        t.shutdown()
    return rec, snap, chip_smoke.fired_steps(chaos)


@pytest.mark.parametrize("script", CROSS_SCRIPTS, ids=CROSS_IDS)
def test_scorecard_identical_across_worlds(script, one_thread, chip_smoke):
    from repro_torch.sim import JobSpec, Simulation, faults

    # -- sim world ----------------------------------------------------
    rec_sim = P.TraceRecorder()
    sim = Simulation(policy="bino", seed=1, n_workers=4, obs=rec_sim,
                     assess_backend="numpy")
    job = sim.submit(JobSpec("j0", "terasort", 2.0))
    faults.apply_script(sim, job, script)
    sim.run()
    card_sim = P.scorecard(rec_sim, policy="bino")

    # -- live runtime world -------------------------------------------
    rec_rt, snap, fired = _port_runtime_world(chip_smoke, script)
    card_rt = P.scorecard(rec_rt, policy="bino")

    assert fired == len(script), "a scripted fault never fired"
    assert P.comparable_core(card_sim) == P.comparable_core(card_rt)
    assert card_sim["recall"] == 1.0
    for card in (card_sim, card_rt):
        assert all(v > 0 for v in card["ttd"].values())
    # the coordinator's metrics plane agrees with the trace plane
    detect = rec_rt.by_kind(P.K_DETECT)
    assert snap["detections"] == len(detect[detect["b"] == 1])
    assert snap["recoveries"] > 0


@pytest.mark.parametrize("script", CROSS_SCRIPTS, ids=CROSS_IDS)
def test_runtime_scorecard_equals_reference_runtime(script, one_thread,
                                                    chip_smoke):
    """The port's runtime world and the reference's ``TrainerRuntime``
    (jax on the CPU, the same model, script, seeds and FakeClock), each
    run until its script has fired and two steps more: the same
    comparable core, every scripted step fired in both."""
    from repro.configs import get_config, reduced_config
    from repro.runtime import (ChaosController, FakeClock, RuntimeConfig,
                               TrainerRuntime)
    from repro.train.loop import TrainConfig

    assert P.K_FAULT == R.K_FAULT     # fired_steps reads either recorder
    rec_port, _snap, fired_port = _port_runtime_world(chip_smoke, script)
    rec_ref = R.TraceRecorder(thread_safe=True)
    chaos = ChaosController(script, horizon=6.0, seed=7)
    t = TrainerRuntime(
        reduced_config(get_config("qwen1.5-0.5b")), TrainConfig(),
        RuntimeConfig(n_hosts=4, microbatches_per_shard=4, recovery="bino",
                      compute_delay=0.02),
        seq_len=32, per_shard_batch=2, seed=0,
        clock=FakeClock(auto_advance=True), chaos=chaos, obs=rec_ref)
    step = iter(range(1 << 30))
    try:
        # the reference's ``run`` restarts its step labels on every call
        chip_smoke.run_until_fired(lambda: [t.coord.run_step(next(step))],
                                   chaos)
    finally:
        t.shutdown()
    assert fired_port == chip_smoke.fired_steps(chaos) == len(script)
    card_port = P.scorecard(rec_port, policy="bino")
    card_ref = R.scorecard(rec_ref, policy="bino")
    assert P.comparable_core(card_port) == R.comparable_core(card_ref)
    assert card_ref["recall"] == 1.0
    for card in (card_port, card_ref):
        assert all(v > 0 for v in card["ttd"].values())
