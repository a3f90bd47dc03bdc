"""The torch port's simulator against the reference package, end to end.

1. **Seed fingerprints** — the port reproduces the six pre-refactor
   action-trace fingerprints of ``tests/test_net.py`` with the numpy
   backend and with the torch backend on the CPU (the kernels' plain
   versions).
2. **Fault harnesses** — yarn and bino under the four harnesses of
   ``tests/test_accel.py``, plus the budgeted and clone policies: the
   port on ``TorchBackend("cpu")`` and the reference on numpy emit
   byte-identical action traces, attempt launches and job results.
3. **The chip smoke's scenario** — ``chip_smoke.scenario`` at a reduced
   size matches the reference for both policies, so the script's main
   path stays runnable.

The same harness code drives both packages: it takes the package's
``sim`` module.
"""
import hashlib
import sys
from pathlib import Path
from typing import Callable, Optional

import pytest

import repro.sim as ref_sim
import repro_torch.sim as port_sim
from repro_torch.accel.torch_backend import TorchBackend

ROOT = Path(__file__).resolve().parents[1]
SHUFFLES = ("rescan", "event", "batch")


def run_traced(pkg, policy: str, fault: Optional[Callable] = None,
               seed: int = 1, gb: float = 2.0, mode: str = "batch",
               assess_backend=None, extra_jobs=()):
    """One seeded run with launch instrumentation (the conftest harness,
    for either package); returns everything the gates compare."""
    sim = pkg.Simulation(policy=policy, seed=seed, shuffle=mode,
                         assess_backend=assess_backend, record_actions=True)
    launches = []
    orig = sim._start_attempt

    def logged(req, node_id):
        launches.append((sim.engine.now, req.task.task_id, node_id,
                         req.reason, req.speculative, req.rollback))
        return orig(req, node_id)

    sim._start_attempt = logged
    job = sim.submit(pkg.JobSpec("j0", "terasort", gb))
    for spec in extra_jobs:
        sim.submit(pkg.JobSpec(*spec))
    if fault is not None:
        fault(pkg, sim, job)
    results = sim.run()
    key = [(r.job_id, r.finish_time, r.n_attempts, r.n_spec_attempts,
            r.n_fetch_failures) for r in results]
    return sim.action_trace, launches, key


# ---------------------------------------------------------------------------
# 1. Seed fingerprints (tests/test_net.py)
# ---------------------------------------------------------------------------
def _crash_mof(pkg, sim, job):
    pkg.faults.crash_node_at(sim, sim.cluster.node_ids[7], 55.0)
    pkg.faults.lose_mof_at_map_progress(sim, job, 0.9, max_stragglers=3)


def _slow_hb(pkg, sim, job):
    pkg.faults.slow_node_at(sim, sim.cluster.node_ids[4], 40.0, factor=0.05,
                            duration=120.0)
    pkg.faults.heartbeat_outage_at(sim, sim.cluster.node_ids[9], 60.0,
                                   duration=45.0)


SEED_FINGERPRINTS = [
    # (scenario, policy, seed, engines, fingerprint)
    (_crash_mof, "yarn", 3, SHUFFLES, "059c90959f3012d2"),
    (_crash_mof, "bino", 3, SHUFFLES, "9bf223a003c8c67c"),
    (_slow_hb, "yarn", 5, ("batch",), "96e5403cf18af4e2"),
    (_slow_hb, "bino", 5, ("batch",), "ce1941cb85569b27"),
    (None, "yarn", 1, ("batch",), "a0e88f161c2bcaad"),
    (None, "bino", 1, ("batch",), "9ccb6a30f96b8737"),
]


def _backend(name):
    return TorchBackend("cpu") if name == "torch-cpu" else name


@pytest.mark.parametrize("backend", ["numpy", "torch-cpu"])
@pytest.mark.parametrize(
    "fault,policy,seed,engines,want", SEED_FINGERPRINTS,
    ids=[f"{p}-s{s}-{(f.__name__ if f else 'nofault')}"
         for f, p, s, _e, _w in SEED_FINGERPRINTS])
def test_port_matches_seed_fingerprints(fault, policy, seed, engines, want,
                                        backend):
    for mode in engines:
        key = run_traced(port_sim, policy, fault, seed=seed, gb=1.0,
                         mode=mode, assess_backend=_backend(backend))
        got = hashlib.sha256(repr(key).encode()).hexdigest()[:16]
        assert got == want, (mode, got)


# ---------------------------------------------------------------------------
# 2. Fault harnesses (tests/test_accel.py), port on torch-cpu vs reference
# ---------------------------------------------------------------------------
def _crash(pkg, sim, job):
    pkg.faults.crash_busiest_node_at_map_progress(sim, job, 0.4)


def _delay(pkg, sim, job):
    def fire():
        counts = {}
        for t in job.maps:
            for a in t.running_attempts():
                counts[a.node_id] = counts.get(a.node_id, 0) + 1
        victim = max(sorted(counts), key=lambda n: counts[n]) \
            if counts else sim.cluster.node_ids[0]
        sim.set_node_speed(victim, 0.05)
        sim.engine.after(150.0, sim.set_node_speed, victim, 1.0)
    sim.engine.at(30.0, fire)


def _mof(pkg, sim, job):
    pkg.faults.lose_mof_at_map_progress(sim, job, 1.0)


def _quorum(pkg, sim, job):
    pkg.faults.lose_mof_at_map_progress(sim, job, 1.0, max_stragglers=16)


def assert_same_run(ref, port):
    for what, a, b in zip(("trace", "launches", "results"), ref, port):
        assert len(a) == len(b), (what, len(a), len(b))
        for k, (x, y) in enumerate(zip(a, b)):
            assert x == y, f"{what}[{k}]: reference {x!r} port {y!r}"


@pytest.mark.parametrize("fault", [_crash, _delay, _mof, _quorum],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("policy", ["yarn", "bino"])
def test_port_matches_reference_under_faults(policy, fault):
    ref = run_traced(ref_sim, policy, fault, assess_backend="numpy")
    port = run_traced(port_sim, policy, fault,
                      assess_backend=TorchBackend("cpu"))
    assert ref[0], "scenario produced no actions — not probing"
    assert_same_run(ref, port)


@pytest.mark.parametrize("policy", ["budgeted", "clone"])
def test_port_matches_reference_cross_job_policies(policy):
    # Cross-job policies under a cluster-wide budget: a large job and a
    # few small ones, a crash in the large job.
    extra = [("s1", "grep", 0.25, 5.0), ("s2", "wordcount", 0.5, 12.0),
             ("s3", "terasort", 0.25, 20.0)]
    ref = run_traced(ref_sim, policy, _crash, gb=3.0,
                     assess_backend="numpy", extra_jobs=extra)
    port = run_traced(port_sim, policy, _crash, gb=3.0,
                      assess_backend=TorchBackend("cpu"), extra_jobs=extra)
    assert ref[0], "scenario produced no actions — not probing"
    assert_same_run(ref, port)


# ---------------------------------------------------------------------------
# 3. chip_smoke.py's main-path scenario, reduced
# ---------------------------------------------------------------------------
def _ref_scenario(policy, n_workers, n_jobs, gb, cap):
    import dataclasses
    from repro.sim.mapreduce import BINO_PARAMS, SimParams
    base = BINO_PARAMS if policy == "bino" else SimParams()
    sim = ref_sim.Simulation(
        policy=policy, seed=0, n_workers=n_workers, n_containers=8,
        assess_backend="numpy",
        params=dataclasses.replace(base, sim_time_cap=cap),
        record_actions=True)
    launches = []
    orig = sim._start_attempt

    def logged(req, node_id):
        launches.append((sim.engine.now, req.task.task_id, node_id,
                         req.reason, req.speculative, req.rollback))
        return orig(req, node_id)

    sim._start_attempt = logged
    jobs = [sim.submit(ref_sim.JobSpec(f"j{i}", "terasort", gb,
                                       submit_time=float(i)))
            for i in range(n_jobs)]
    ref_sim.faults.crash_busiest_node_at_map_progress(sim, jobs[0], 0.4)
    ref_sim.faults.lose_mof_at_map_progress(sim, jobs[1], 1.0)
    results = sim.run()
    return sim.action_trace, launches, [
        (r.job_id, r.finish_time, r.n_attempts, r.n_spec_attempts,
         r.n_fetch_failures) for r in results]


@pytest.mark.parametrize("policy", ["bino", "yarn"])
def test_chip_smoke_scenario_matches_reference(policy):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    size = dict(n_workers=60, n_jobs=3, gb=6.0, cap=120.0)
    sim, launches, key, _wall = chip_smoke.scenario(
        policy, TorchBackend("cpu"), **size)
    ref = _ref_scenario(policy, **size)
    assert ref[0], "scenario produced no actions — not probing"
    assert_same_run(ref, (sim.action_trace, launches, key))
