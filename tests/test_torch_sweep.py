"""The torch port's batched scenario sweep against the reference package.

1. **Scenario grid** — ``scenario_grid`` gives the reference's scenarios
   (with and without racks, and at the chip smoke's 64 scenarios over
   1,000 nodes and 40 racks).
2. **Sweep** — on reference snapshots (mid-run on a 4-rack topology, and
   synthetic snapshots with reapable siblings, carried into the port
   with ``snapshot_from_state``), the port's ``run_batched(device=
   "cpu")`` equals the port's ``run_serial`` and the reference's
   ``BatchedSweep.run_serial`` in every scenario and field, N = 10.
3. **Scenario axis** — each scenario's slice of the batched kernel
   arguments equals the per-tick backend's arguments on that scenario's
   clone, and the batched plain versions equal per-tick calls; B3's
   winning verdict reads neither ``min_runtime`` nor the percentile, so
   one launch serves both outputs.
4. **On the card** (marked ``cuda``; they skip without one) — the
   batched kernels equal their plain versions and one N = 1 launch per
   scenario, and ``run_batched`` on the card equals ``run_serial``.
5. **The chip smoke's sweep phase** at a reduced size on the CPU.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.sim as ref_sim
from repro.accel.sweep import BatchedSweep as RefSweep
from repro.accel.sweep import scenario_grid as ref_grid
from repro_torch.accel import kernels as K
from repro_torch.accel import torch_backend as TB
from repro_torch.accel.sweep import BatchedSweep, Scenario, scenario_grid
from repro_torch.accel.torch_backend import TorchBackend
from repro_torch.core.arrays import snapshot_from_state, snapshot_state
from repro_torch.core.glance import build_neighborhoods
from test_torch_assess import synthetic_snapshot

ROOT = Path(__file__).resolve().parents[1]
N = 10
FIELDS = ("spatial_hits", "failed", "late_victims", "winning", "n_reap")


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


# ---------------------------------------------------------------------------
# Reference snapshots
# ---------------------------------------------------------------------------
def _topo_snapshot(policy, seed, until):
    sim = ref_sim.Simulation(policy=policy, seed=seed, net="topo", racks=4,
                             assess_backend="numpy")
    job = sim.submit(ref_sim.JobSpec("j0", "terasort", 6.0))
    sim.submit(ref_sim.JobSpec("j1", "terasort", 3.0, submit_time=5.0))
    ref_sim.faults.crash_busiest_node_at_map_progress(sim, job, 0.4)
    sim.engine.run(until=until)
    return sim.arrays, until


def _synthetic(seed):
    rng = np.random.default_rng(seed)
    arr = synthetic_snapshot(rng, n_nodes=16, n_jobs=4)
    # a 4-rack layout for the rack-degrade scenarios
    arr.node_rack = (np.arange(16) // 4).astype(np.int32)
    arr.rack_factor = np.ones(4)
    arr.rack_flows = np.zeros(4, dtype=np.int32)
    return arr, 100.0


SNAPSHOTS = {
    "topo-yarn": lambda: _topo_snapshot("yarn", 2, 80.0),
    "topo-bino": lambda: _topo_snapshot("bino", 3, 120.0),
    "synthetic-0": lambda: _synthetic(0),
    "synthetic-1": lambda: _synthetic(1),
    "synthetic-2": lambda: _synthetic(2),
}
_CACHE = {}


def snapshot(name):
    if name not in _CACHE:
        _CACHE[name] = SNAPSHOTS[name]()
    return _CACHE[name]


def _grid(arr):
    grid = scenario_grid(N - 1, len(arr.node_ids), seed=1, n_racks=4)
    return grid + [Scenario("baseline")]


def _port_sweep(name):
    ref, now = snapshot(name)
    port = snapshot_from_state(snapshot_state(ref))
    return BatchedSweep(port, now).prepare(_grid(port))


def assert_same_sweep(got, want):
    assert len(got) == len(want) == N
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w) == set(FIELDS)
        for f in FIELDS:
            assert np.array_equal(np.asarray(g[f]), np.asarray(w[f])), \
                (i, f, g[f], w[f])


# ---------------------------------------------------------------------------
# 1. Scenario grid
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,nodes,seed,racks", [
    (10, 20, 0, 1), (10, 20, 1, 4), (17, 12, 5, 3), (64, 1000, 1, 40)])
def test_scenario_grid_matches_reference(n, nodes, seed, racks):
    got = scenario_grid(n, nodes, seed=seed, n_racks=racks)
    want = ref_grid(n, nodes, seed=seed, n_racks=racks)
    assert [vars(g) for g in got] == [vars(w) for w in want]
    kinds = {g.kind for g in got}
    assert ("rack_degrade" in kinds) == (racks > 1)


# ---------------------------------------------------------------------------
# 2. Sweep: port batched (CPU) == port serial == reference serial
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_sweep_matches_reference(name):
    ref, now = snapshot(name)
    want = RefSweep(ref, now).prepare(_grid(ref)).run_serial()
    sweep = _port_sweep(name)
    serial = sweep.run_serial()
    assert_same_sweep(serial, want)
    before = dict(K.launches)
    assert_same_sweep(sweep.run_batched("cpu"), want)
    assert K.launches == before, "a CPU sweep must not count a launch"


def test_sweep_probes_nontrivial_outcomes():
    # The comparison above must see victims, hits, failures, winning
    # jobs and reapable rows — not only empty results.
    seen = set()
    for name in SNAPSHOTS:
        for r in _port_sweep(name).run_serial():
            if (r["late_victims"] >= 0).any():
                seen.add("late_victims")
            for f in ("spatial_hits", "failed", "winning"):
                if r[f].any():
                    seen.add(f)
            if r["n_reap"]:
                seen.add("n_reap")
    assert seen == set(FIELDS), set(FIELDS) - seen


# ---------------------------------------------------------------------------
# 3. The scenario axis
# ---------------------------------------------------------------------------
def _rows(name, args):
    return args[:_chip_smoke().ROW_ARGS[name]]


@pytest.mark.parametrize("name", ["topo-bino", "synthetic-1"])
def test_batched_args_match_per_tick_args(name):
    sweep = _port_sweep(name)
    args, _cols = sweep.kernel_args("cpu")
    one = _chip_smoke().one_scenario
    for s, clone in enumerate(sweep.clones):
        backend = TorchBackend("cpu")
        tick = {
            "spatial": backend.spatial_args(clone, sweep.now, sweep.active,
                                            sweep.neighborhoods),
            "late": backend.late_args(clone, sweep.now, sweep.active,
                                      sweep.min_runtime,
                                      sweep.slow_task_percentile,
                                      sweep.win_factor),
            "reap": backend.reap_args(clone, sweep.now),
        }
        for kernel, want in tick.items():
            got = one(kernel, args[kernel], s)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                if isinstance(w, torch.Tensor):
                    assert torch.equal(g, w), (kernel, s)
                else:
                    assert g == w, (kernel, s)


@pytest.mark.parametrize("name", ["topo-yarn", "synthetic-2"])
def test_batched_plain_versions_match_per_scenario_calls(name):
    args, _cols = _port_sweep(name).kernel_args("cpu")
    one = _chip_smoke().one_scenario
    fns = {"spatial": TB.spatial, "late": TB.late, "reap": TB.reap}
    for kernel, fn in fns.items():
        got = fn(*args[kernel])
        for s in range(N):
            want = fn(*one(kernel, args[kernel], s))
            for g, w in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                assert torch.equal(g[s], w), (kernel, s)


@pytest.mark.parametrize("name", ["topo-bino", "synthetic-0"])
def test_winning_ignores_min_runtime_and_percentile(name):
    args, _cols = _port_sweep(name).kernel_args("cpu")
    late = args["late"]
    rows, (now, _mr, _q, wf, jcap) = late[:9], late[9:]
    wins = [TB.late(*rows, now, mr, q, wf, jcap)[1]
            for mr, q in ((0.0, 0.0), (10.0, 25.0), (1e9, 100.0))]
    assert torch.equal(wins[0], wins[1]) and torch.equal(wins[1], wins[2])
    assert wins[0].any()


def test_run_batched_defaults_to_the_card(monkeypatch):
    sweep = _port_sweep("synthetic-0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep.run_batched()
    fresh = BatchedSweep(sweep.arr, sweep.now)
    with pytest.raises(RuntimeError, match="prepare"):
        fresh.run_batched("cpu")
    with pytest.raises(RuntimeError, match="prepare"):
        fresh.run_serial()


def test_sweep_neighborhoods_are_the_glance_default():
    sweep = _port_sweep("synthetic-0")
    assert np.array_equal(sweep.neighborhoods,
                          build_neighborhoods(sweep.arr.node_ids))


# ---------------------------------------------------------------------------
# 4. On the card (skips without one)
# ---------------------------------------------------------------------------
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_batched_kernels_on_card(name):
    _need_card()
    sweep = _port_sweep(name)
    dev, _c = sweep.kernel_args("cuda")
    cpu, _c = sweep.kernel_args("cpu")
    one = _chip_smoke().one_scenario
    fns = {"spatial": (TB.spatial, TB.spatial_ref),
           "late": (TB.late, TB.late_ref), "reap": (TB.reap, TB.reap_ref)}
    for kernel, (fn, ref) in fns.items():
        before = K.launches[kernel + "_sweep"]
        got = fn(*dev[kernel])
        assert K.launches[kernel + "_sweep"] == before + 1
        want = ref(*cpu[kernel])
        got_t = got if isinstance(got, tuple) else (got,)
        want_t = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got_t, want_t):
            assert torch.equal(g.cpu(), w), kernel
        for s in range(N):
            single = fn(*one(kernel, dev[kernel], s))
            single = single if isinstance(single, tuple) else (single,)
            for g, w in zip(got_t, single):
                assert torch.equal(g[s], w), (kernel, s)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_run_batched_on_card_matches_serial(name):
    _need_card()
    sweep = _port_sweep(name)
    before = dict(K.launches)
    got = sweep.run_batched()
    for k in ("spatial_sweep", "late_sweep", "reap_sweep"):
        assert K.launches[k] == before[k] + 1, k
    assert_same_sweep(got, sweep.run_serial())


# ---------------------------------------------------------------------------
# 5. chip_smoke.py's sweep phase, reduced, on the CPU
# ---------------------------------------------------------------------------
def test_chip_smoke_sweep_path_on_cpu():
    cs = _chip_smoke()
    assess, bulk, got = cs.recording_backends("cpu", at=60.0)
    cs.fair_scenario(assess, bulk, racks=4, n_workers=60, n_jobs=3, gb=6.0,
                     cap=90.0)
    sweep, counts = cs.sweep_path(got["state"], got["now"], device="cpu",
                                  n_scen=10, racks=4)
    assert len(sweep.clones) == 10
    assert not any(counts.values()), "a CPU sweep must not count a launch"
