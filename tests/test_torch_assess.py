"""The torch port's assessment backend against the reference package.

Snapshots are recorded from reference simulations of the four fault
harnesses of ``tests/test_accel.py`` (yarn under crash and fetch-quorum
faults, bino under delay and MOF loss), sampled every few ticks together
with each backend call's arguments and the reference numpy result. Each
snapshot is carried into the port with ``snapshot_from_state`` and the
same call runs on ``TorchBackend("cpu")`` — the plain torch versions of
kernels B1–B4 plus the Eq. 4 masks.

1. **Plain versions vs numpy** — every output equals
   ``repro.accel.numpy_backend.NumpyBackend``'s exactly (NaN equal to
   NaN for ζ; LATE victims where the job is eligible, as the caller
   reads them).
2. **Plain versions vs Pallas** — the same calls on the reference
   ``PallasBackend`` in interpret mode, run in a child process: jax 0.9
   no longer exports ``jax.experimental.enable_x64``, which the reference
   imports, so the child restores it before importing the reference's
   jax modules. This test process never patches jax. Records and results
   cross as ``.npz`` files.
3. **Boundary inputs** — ``chip_smoke.adversarial_inputs`` (the inputs
   the card run also feeds the kernels) put Eq. 1 on its exact boundary
   and make bucket sums order-dependent; the plain versions match numpy
   there, and the percentile helper matches ``np.percentile``.
4. **On the card** (marked ``cuda``; they skip without one) — each CUDA
   kernel equals its plain version on the boundary inputs, and the
   backend on the card reproduces every recorded numpy result.
5. **Kernel wrappers** — the CPU dispatch reaches the plain versions, and
   argument checks refuse bad inputs before anything is built.

``chip_smoke.py`` also holds each kernel against its plain version on
the card, at the main path's sizes.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.accel.numpy_backend import NumpyBackend as RefNumpyBackend
from repro.core.glance import build_neighborhoods
from repro.sim import JobSpec, Simulation, faults
from repro_torch.accel import kernels as K
from repro_torch.accel import torch_backend as TB
from repro_torch.accel.base import TMARK, TPROG
from repro_torch.accel.torch_backend import TorchBackend
from repro_torch.core.arrays import snapshot_from_state, snapshot_state

ROOT = Path(__file__).resolve().parents[1]
METHODS = ("spatial_hits", "temporal_zeta", "failure_masks", "late_victims",
           "winning", "reap_rows")
SAMPLE_EVERY = 9        # ticks between sampled ticks
MAX_SAMPLES = 10        # sampled ticks per harness


# ---------------------------------------------------------------------------
# Reference harnesses (as tests/test_accel.py)
# ---------------------------------------------------------------------------
def _crash(sim, job):
    faults.crash_busiest_node_at_map_progress(sim, job, 0.4)


def _delay(sim, job):
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


def _mof(sim, job):
    faults.lose_mof_at_map_progress(sim, job, 1.0)


def _quorum(sim, job):
    faults.lose_mof_at_map_progress(sim, job, 1.0, max_stragglers=16)


HARNESSES = [("yarn", _crash), ("yarn", _quorum), ("bino", _delay),
             ("bino", _mof)]


def _active_args(active):
    return {"active_ids": np.asarray([j for j, _ in active], dtype=str),
            "active_idx": np.asarray([i for _, i in active],
                                     dtype=np.int64)}


def _active(args):
    return [(str(j), int(i)) for j, i in zip(args["active_ids"],
                                             args["active_idx"])]


class Recorder(RefNumpyBackend):
    """The reference numpy backend, recording sampled calls: the
    snapshot's state before the call, the arguments and the result. At
    each sampled tick it also probes LATE (every job eligible), winning
    (every job) and the spatial pass on a clone, so both policies'
    snapshots reach every function; ticks with reapable rows are kept
    whether sampled or not."""

    def __init__(self):
        super().__init__()
        self.records = []
        self._ticks = []
        self._probed = set()

    def _sampled(self, now):
        if not self._ticks or self._ticks[-1] != now:
            self._ticks.append(now)
        k = len(self._ticks) - 1
        return k % SAMPLE_EVERY == 0 and k // SAMPLE_EVERY < MAX_SAMPLES

    def _keep(self, method, arr, now, args, result, post=None):
        rec = {"method": method, "now": now, "args": args,
               "result": result, "post": post,
               "state": snapshot_state(arr) if arr is not None else None}
        self.records.append(rec)

    def _probe(self, arr, now):
        if now in self._probed:
            return
        self._probed.add(now)
        active = arr.active_jobs()
        if not active:
            return
        clone = arr.clone_for_assessment()
        ref = RefNumpyBackend()
        eligible = np.ones(len(active), dtype=bool)
        args = dict(_active_args(active), eligible=eligible,
                    min_runtime=10.0, q=25.0)
        self._keep("late_victims", arr, now, args,
                   ref.late_victims(clone, now, active, eligible, 10.0,
                                    25.0))
        for _jid, jidx in active:
            self._keep("winning", arr, now,
                       {"job_idx": jidx, "win_factor": 1.0},
                       ref.winning(clone, now, jidx, 1.0))
        nh = build_neighborhoods(arr.node_ids, 4)
        self._keep("spatial_hits", arr, now,
                   dict(_active_args(active), neighborhoods=nh),
                   ref.spatial_hits(clone, now, active, nh))

    def spatial_hits(self, arr, now, active, neighborhoods):
        out = super().spatial_hits(arr, now, active, neighborhoods)
        if self._sampled(now):
            self._keep("spatial_hits", arr, now,
                       dict(_active_args(active),
                            neighborhoods=neighborhoods), out)
        return out

    def temporal_zeta(self, arr, now, active, samp_flag, init_flag, prevk):
        keep = self._sampled(now)
        state = snapshot_state(arr) if keep else None
        out = super().temporal_zeta(arr, now, active, samp_flag, init_flag,
                                    prevk)
        if keep:
            post = {"mark": arr.scratch(TMARK, np.int64, -1)[:arr.n].copy(),
                    "tprog": arr.scratch(TPROG, np.float64,
                                         np.nan)[:arr.n].copy()}
            self.records.append({
                "method": "temporal_zeta", "now": now, "state": state,
                "args": dict(_active_args(active), samp_flag=samp_flag,
                             init_flag=init_flag, prevk=prevk),
                "result": out, "post": post})
        return out

    def failure_masks(self, now, node_hb, node_marked, declared, thresholds,
                      responsive_window):
        out = super().failure_masks(now, node_hb, node_marked, declared,
                                    thresholds, responsive_window)
        if self._sampled(now):
            self._keep("failure_masks", None, now, {
                "node_hb": node_hb.copy(), "node_marked": node_marked.copy(),
                "declared": declared.copy(), "thresholds": thresholds.copy(),
                "responsive_window": responsive_window}, out)
        return out

    def late_victims(self, arr, now, active, eligible, min_runtime,
                     slow_task_percentile):
        out = super().late_victims(arr, now, active, eligible, min_runtime,
                                   slow_task_percentile)
        if self._sampled(now):
            self._keep("late_victims", arr, now,
                       dict(_active_args(active), eligible=eligible.copy(),
                            min_runtime=min_runtime,
                            q=slow_task_percentile), out)
        return out

    def winning(self, arr, now, job_idx, win_factor):
        out = super().winning(arr, now, job_idx, win_factor)
        if self._sampled(now):
            self._keep("winning", arr, now,
                       {"job_idx": job_idx, "win_factor": win_factor}, out)
        return out

    def reap_rows(self, arr, now):
        out = super().reap_rows(arr, now)
        if self._sampled(now):
            self._keep("reap_rows", arr, now, {}, out)
            self._probe(arr, now)
        elif len(out):
            # Reapable siblings last one tick: keep every such tick.
            self._keep("reap_rows", arr, now, {}, out)
        return out


def call(backend, arr, method, now, args):
    """Replay one recorded call on ``backend`` (either package's)."""
    if method == "spatial_hits":
        return backend.spatial_hits(arr, now, _active(args),
                                    np.asarray(args["neighborhoods"]))
    if method == "temporal_zeta":
        zn, zp = backend.temporal_zeta(
            arr, now, _active(args), np.asarray(args["samp_flag"]),
            np.asarray(args["init_flag"]), np.asarray(args["prevk"]))
        return (zn, zp, arr.scratch(TMARK, np.int64, -1)[:arr.n].copy(),
                arr.scratch(TPROG, np.float64, np.nan)[:arr.n].copy())
    if method == "failure_masks":
        return backend.failure_masks(
            now, np.asarray(args["node_hb"]),
            np.asarray(args["node_marked"]), np.asarray(args["declared"]),
            np.asarray(args["thresholds"]),
            float(args["responsive_window"]))
    if method == "late_victims":
        return backend.late_victims(
            arr, now, _active(args), np.asarray(args["eligible"]),
            float(args["min_runtime"]), float(args["q"]))
    if method == "winning":
        return backend.winning(arr, now, int(args["job_idx"]),
                               float(args["win_factor"]))
    return backend.reap_rows(arr, now)


def expected(rec):
    """The reference numpy output in :func:`call`'s layout."""
    if rec["method"] == "temporal_zeta":
        zn, zp = rec["result"]
        return zn, zp, rec["post"]["mark"], rec["post"]["tprog"]
    return rec["result"]


def assert_same(method, got, want, args):
    if method == "late_victims":
        # The caller reads victims of eligible jobs only.
        e = np.asarray(args["eligible"], dtype=bool)
        got, want = np.asarray(got)[e], np.asarray(want)[e]
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (method, g.shape, w.shape)
        assert np.array_equal(g, w, equal_nan=g.dtype.kind == "f"), method


def synthetic_records(seed, n_nodes=12, n_jobs=3, now=100.0):
    """Records of every snapshot call on a random snapshot: tasks of one
    to three attempts in mixed attempt and task states (so completed
    tasks with running siblings exist for the reap pass), progress and
    start times from small sets (ties), random speculative flags, node
    speeds and Eq. 2 marks, one job finished."""
    from repro.core.arrays import ArraySnapshot as RefSnapshot
    from repro.core.types import AttemptState, TaskKind, TaskState
    rng = np.random.default_rng(seed)
    arr = RefSnapshot([f"n{i:02d}" for i in range(n_nodes)])
    arr.node_speed[:] = rng.uniform(0.2, 1.5, n_nodes)
    jobs = [arr.job_started(f"j{j}") for j in range(n_jobs)]
    astates = [AttemptState.RUNNING, AttemptState.COMPLETED,
               AttemptState.FAILED, AttemptState.KILLED]
    for t in range(int(rng.integers(20, 40))):
        jidx = int(rng.choice(jobs))
        arr.task_created(jidx)
        kind = TaskKind.MAP if rng.random() < 0.6 else TaskKind.REDUCE
        tstate = TaskState.COMPLETED if rng.random() < 0.3 \
            else TaskState.RUNNING
        for a in range(int(rng.integers(1, 4))):
            owner = type("Owner", (), {"row": -1})()
            # Values from small sets: ties between attempts and tasks.
            start = float(rng.choice([0.0, 20.0, 50.0, 85.0, 95.0]))
            total = float(rng.choice([40.0, 80.0]))
            deps = int(rng.integers(1, 6))
            row = arr.add_attempt(
                owner, f"a{t}_{a}", f"t{t}", t, a, jidx,
                int(rng.integers(0, n_nodes)), kind,
                bool(rng.random() < 0.25), start,
                float(rng.choice([0.0, 10.0, 20.0, 30.0])), total, deps,
                tstate)
            owner.row = row
            arr.set_attempt_state(row, astates[int(rng.choice(
                4, p=[0.6, 0.25, 0.1, 0.05]))])
            arr.sync_row(row, arr.work_done[row],
                         float(rng.choice([start, now])))
            arr.fetched[row] = int(rng.integers(0, deps + 1))
            arr.compute[row] = bool(rng.random() < 0.5)
    arr.job_finished("j0")
    mark = arr.scratch(TMARK, np.int64, -1)
    mark[:arr.n] = rng.integers(-1, 3, arr.n)
    tprog = arr.scratch(TPROG, np.float64, np.nan)
    tprog[:arr.n] = rng.uniform(0.0, 1.0, arr.n)
    active = arr.active_jobs()
    J = len(active)
    ref = RefNumpyBackend()
    recs = []

    def keep(method, args, result, state=None, post=None):
        recs.append({"method": method, "now": now, "args": args,
                     "result": result, "post": post,
                     "state": state or snapshot_state(arr)})

    nh = build_neighborhoods(arr.node_ids, 4)
    keep("spatial_hits", dict(_active_args(active), neighborhoods=nh),
         ref.spatial_hits(arr.clone_for_assessment(), now, active, nh))
    for q in (25.0, 50.0, 90.0):
        eligible = rng.random(J) < 0.8
        keep("late_victims", dict(_active_args(active), eligible=eligible,
                                  min_runtime=10.0, q=q),
             ref.late_victims(arr.clone_for_assessment(), now, active,
                              eligible, 10.0, q))
    for _jid, jidx in active:
        for wf in (1.0, 1.5):
            keep("winning", {"job_idx": jidx, "win_factor": wf},
                 ref.winning(arr.clone_for_assessment(), now, jidx, wf))
    keep("reap_rows", {}, ref.reap_rows(arr.clone_for_assessment(), now))
    args = dict(_active_args(active), samp_flag=rng.random(J) < 0.7,
                init_flag=rng.random(J) < 0.3,
                prevk=rng.integers(0, 3, J).astype(np.int64))
    state = snapshot_state(arr)
    clone = arr.clone_for_assessment()
    out = ref.temporal_zeta(clone, now, active, args["samp_flag"],
                            args["init_flag"], args["prevk"])
    keep("temporal_zeta", args, out, state=state, post={
        "mark": clone.scratch(TMARK, np.int64, -1)[:clone.n].copy(),
        "tprog": clone.scratch(TPROG, np.float64, np.nan)[:clone.n].copy()})
    return recs


SYNTHETIC_SEEDS = range(6)
_RECORDS = {}


def recorded():
    """All sampled records of the four harnesses plus the synthetic
    snapshots (cached per process)."""
    if not _RECORDS:
        for policy, fault in HARNESSES:
            rec = Recorder()
            sim = Simulation(policy=policy, seed=1, assess_backend=rec)
            job = sim.submit(JobSpec("j0", "terasort", 2.0))
            fault(sim, job)
            sim.run()
            _RECORDS[f"{policy}-{fault.__name__}"] = rec.records
        for seed in SYNTHETIC_SEEDS:
            _RECORDS[f"synthetic-{seed}"] = synthetic_records(seed)
    return _RECORDS


def _port_result(rec):
    arr = snapshot_from_state(rec["state"]) if rec["state"] else None
    return call(TorchBackend("cpu"), arr, rec["method"], rec["now"],
                rec["args"])


# ---------------------------------------------------------------------------
# 1. Plain versions vs the reference numpy backend
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method", METHODS)
def test_plain_versions_match_numpy(method):
    n = 0
    for name, recs in recorded().items():
        for rec in recs:
            if rec["method"] != method:
                continue
            assert_same(method, _port_result(rec), expected(rec),
                        rec["args"])
            n += 1
    assert n >= 5, f"only {n} {method} records: not probing"


def test_records_probe_nontrivial_outcomes():
    # The comparison above must see fired hits, surviving ζ, victims,
    # winning jobs and reapable rows — not only empty results.
    seen = set()
    for recs in recorded().values():
        for rec in recs:
            m, r = rec["method"], rec["result"]
            if m == "spatial_hits" and np.any(r):
                seen.add(m)
            if m == "temporal_zeta" and np.any(~np.isnan(r[0])):
                seen.add(m)
            if m == "late_victims" and np.any(r >= 0):
                seen.add(m)
            if m in ("winning", "reap_rows") and np.any(r):
                seen.add(m)
            if m == "failure_masks" and np.any(r[0]):
                seen.add(m)
    assert seen == set(METHODS), set(METHODS) - seen


# ---------------------------------------------------------------------------
# 2. Plain versions vs the Pallas kernels (interpret mode, child process)
# ---------------------------------------------------------------------------
def _save_record(path, rec):
    data = {"method": np.asarray(rec["method"]),
            "now": np.asarray(rec["now"], dtype=np.float64)}
    for k, v in (rec["state"] or {}).items():
        data["s/" + k] = v
    for k, v in rec["args"].items():
        data["a/" + k] = np.asarray(v)
    np.savez(path, **data)


def _load_record(path):
    z = np.load(path)
    state = {k[2:]: z[k] for k in z.files if k.startswith("s/")}
    args = {k[2:]: z[k] for k in z.files if k.startswith("a/")}
    return str(z["method"]), float(z["now"]), state or None, args


def pallas_child(indir, outdir):
    """Child-process body: replay every record on the reference
    PallasBackend (interpret mode) and write the results."""
    from repro.accel.pallas_backend import INTERPRET, PallasBackend
    from repro.core.arrays import ArraySnapshot as RefSnapshot
    assert INTERPRET, "the Pallas reference must run in interpret mode"
    for path in sorted(Path(indir).glob("*.npz")):
        method, now, state, args = _load_record(path)
        arr = None
        if state is not None:
            port = snapshot_from_state(state)
            arr = RefSnapshot(list(port.node_ids))
            arr.__dict__.update(port.__dict__)
        out = call(PallasBackend(), arr, method, now, args)
        outs = out if isinstance(out, tuple) else (out,)
        np.savez(Path(outdir) / path.name,
                 **{f"o{i}": np.asarray(o) for i, o in enumerate(outs)})


_CHILD = """
import sys
import jax
import jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)
sys.path.insert(0, sys.argv[1])
import test_torch_assess
test_torch_assess.pallas_child(sys.argv[2], sys.argv[3])
"""


@pytest.fixture(scope="module")
def pallas_results(tmp_path_factory):
    pytest.importorskip("jax")
    indir = tmp_path_factory.mktemp("records")
    outdir = tmp_path_factory.mktemp("pallas")
    recs = [r for rs in recorded().values() for r in rs]
    for i, rec in enumerate(recs):
        _save_record(indir / f"r{i:04d}.npz", rec)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    env.setdefault("JAX_PLATFORMS", "cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, str(ROOT / "tests"), str(indir),
         str(outdir)], env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = []
    for i, rec in enumerate(recs):
        z = np.load(outdir / f"r{i:04d}.npz")
        vals = tuple(z[f"o{k}"] for k in range(len(z.files)))
        out.append((rec, vals if len(vals) > 1 else vals[0]))
    return out


@pytest.mark.parametrize("method", METHODS)
def test_plain_versions_match_pallas(method, pallas_results):
    n = 0
    for rec, pallas in pallas_results:
        if rec["method"] != method:
            continue
        assert_same(method, _port_result(rec), pallas, rec["args"])
        n += 1
    assert n >= 5, f"only {n} {method} records: not probing"


# ---------------------------------------------------------------------------
# 3. Boundary inputs (chip_smoke.adversarial_inputs) vs numpy
# ---------------------------------------------------------------------------
def _adversarial_on(seed, device):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke.adversarial_inputs(seed, device)


def _adversarial(seed):
    return _adversarial_on(seed, "cpu")


@pytest.mark.parametrize("seed", range(4))
def test_spatial_plain_on_eq1_boundary_matches_numpy(seed):
    from repro.core.metrics import spatial_slow_mask_batch_np
    rho, node, kind, jls, running, nh, jcap = _adversarial(seed)["spatial"]
    n = nh.shape[0]
    P = np.full(jcap * 2 * n, np.nan)
    run = running.numpy() == 1
    seg = (jls.numpy() * 2 + kind.numpy()) * n + node.numpy()
    P[seg[run]] = rho.numpy()[run]          # one row per bucket
    want = spatial_slow_mask_batch_np(P.reshape(jcap * 2, n), nh.numpy())
    got = TB.spatial_ref(rho, node, kind, jls, running, nh, jcap)
    assert want.any()
    assert np.array_equal(got.numpy().reshape(jcap * 2, n), want)


@pytest.mark.parametrize("seed", range(4))
def test_temporal_plain_sums_in_bincount_order(seed):
    prog, tprog, node, jls, alive, jcap, n = _adversarial(seed)["temporal"]
    use = alive.numpy() == 1
    seg = (jls.numpy() * n + node.numpy())[use]
    cnt = np.bincount(seg, minlength=jcap * n)
    zn, zp = TB.temporal_ref(prog, tprog, node, jls, alive, jcap, n)
    for got, w in ((zn, prog), (zp, tprog)):
        want = np.bincount(seg, weights=w.numpy()[use], minlength=jcap * n)
        want = np.where(cnt > 0, want, np.nan).reshape(jcap, n)
        assert np.array_equal(got.numpy(), want, equal_nan=True)


@pytest.mark.parametrize("seed", range(4))
def test_reap_plain_matches_numpy(seed):
    a_state, tseg, live = _adversarial(seed)["reap"]
    a, ts, lv = a_state.numpy(), tseg.numpy(), live.numpy() == 1
    done = np.bincount(ts[lv & (a == 1)], minlength=len(a)) > 0
    want = lv & (a == 0) & done[ts]
    assert want.any()
    assert np.array_equal(TB.reap_ref(a_state, tseg, live).numpy(), want)


def test_percentile_runs_match_numpy():
    rng = np.random.default_rng(0)
    for m in list(range(1, 24)) + [101]:
        vals = rng.random(m) * rng.choice([1e-6, 1.0, 1e6])
        srt = torch.from_numpy(np.concatenate(
            [np.full(3, -1.0), np.sort(vals), np.full(5, np.inf)]))
        for q in (0.0, 10.0, 25.0, 50.0, 75.0, 90.0, 100.0):
            got = TB.percentile_runs(srt, torch.tensor([3]),
                                     torch.tensor([m]), q)
            assert float(got[0]) == float(np.percentile(vals, q)), (m, q)


# ---------------------------------------------------------------------------
# 4. On the card (skips without one): the CUDA kernels themselves
# ---------------------------------------------------------------------------
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(4))
def test_kernels_match_plain_versions_on_card(seed):
    _need_card()
    dev, cpu = _adversarial_on(seed, "cuda"), _adversarial(seed)
    fns = {"spatial": TB.spatial, "temporal": TB.temporal, "late": TB.late,
           "reap": TB.reap}
    refs = {"spatial": TB.spatial_ref, "temporal": TB.temporal_ref,
            "late": TB.late_ref, "reap": TB.reap_ref}
    for name, fn in fns.items():
        before = K.launches[name]
        got = fn(*dev[name])
        assert K.launches[name] == before + 1, name
        want = refs[name](*cpu[name])
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert np.array_equal(g.cpu().numpy(), w.numpy(),
                                  equal_nan=w.is_floating_point()), name


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
def test_card_backend_matches_numpy(method):
    _need_card()
    n = 0
    for recs in recorded().values():
        for rec in recs:
            if rec["method"] != method:
                continue
            arr = snapshot_from_state(rec["state"]) if rec["state"] \
                else None
            got = call(TorchBackend("cuda"), arr, method, rec["now"],
                       rec["args"])
            assert_same(method, got, expected(rec), rec["args"])
            n += 1
    assert n >= 5


# ---------------------------------------------------------------------------
# 5. Kernel wrappers
# ---------------------------------------------------------------------------
def _kernel_args(method):
    recs = [r for rs in recorded().values() for r in rs
            if r["method"] == method]
    rec = recs[len(recs) // 2]
    arr = snapshot_from_state(rec["state"])
    backend = TorchBackend("cpu")
    p, jcap = backend._prep(arr, rec["now"], arr.active_jobs())
    return arr, rec["now"], p, jcap


def test_cpu_tensors_dispatch_to_plain_versions():
    arr, now, p, jcap = _kernel_args("reap_rows")
    i32 = torch.int32
    before = dict(K.launches)
    live = (p["active"] & (p["t_state"] == 2)).to(i32)
    assert torch.equal(TB.reap(p["a_state32"], p["tseg32"], live),
                       TB.reap_ref(p["a_state32"], p["tseg32"], live))
    rate = p["prog"] / torch.clamp_min(now - p["start"], 1e-9)
    nh = torch.from_numpy(
        build_neighborhoods(arr.node_ids, 4).astype(np.int32))
    args = (rate, p["node32"], p["kind32"], p["jls32"],
            p["running"].to(i32), nh, jcap)
    assert torch.equal(TB.spatial(*args), TB.spatial_ref(*args))
    assert K.launches == before, "a CPU call must not count a launch"
    assert K._lib is None, "nothing is built on a CPU run"


def test_wrappers_refuse_other_devices():
    meta = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="devices"):
        TB.reap(meta, meta, meta)
    with pytest.raises(ValueError, match="devices"):
        TB.reap(meta, torch.zeros(8, dtype=torch.int32), meta)


def test_late_refuses_percentile_outside_range():
    args = ([torch.zeros(4, dtype=torch.float64)] * 3
            + [torch.zeros(4, dtype=torch.int32)] * 6)
    with pytest.raises(ValueError, match="percentile"):
        TB.late(*args, 0.0, 10.0, 125.0, 1.0, 4)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity"])
def test_launchers_check_arguments_before_building(bad):
    cap = 8
    f64 = torch.zeros(cap, dtype=torch.float64)
    i32 = torch.zeros(cap, dtype=torch.int32)
    a_state = {"dtype": f64, "shape": torch.zeros(cap + 1, dtype=torch.int32),
               "contiguity": torch.zeros(2 * cap, dtype=torch.int32)[::2]}
    with pytest.raises((TypeError, ValueError)):
        K.launch_reap(a_state[bad], i32, i32)
    assert K._lib is None
