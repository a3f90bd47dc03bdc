#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the simulator on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing falls back):

1. Print the card (``nvidia-smi``), torch/CUDA versions, and build the
   assessment kernels B1–B4 from ``src/repro_torch/accel/csrc/assess.cu``
   with ``nvcc`` (timed).
2. Kernel phase: each kernel on the card against its plain torch version
   on CPU copies of the same inputs, exactly (NaN equal to NaN) — first on
   :func:`adversarial_inputs` (summation-order and tie boundary cases),
   then on a mid-run snapshot of the main-path scenario, where kernel and
   plain version are also timed on the card with CUDA events.
3. Main path: the 1,000-node, 20-job scenario under ``policy="bino"`` and
   ``policy="yarn"``, each once with the default backend (torch on the
   card) and once with ``assess_backend="numpy"``. Action traces,
   attempt launches and job results must be byte-identical, and every
   kernel must have launched during the card runs; B3 must have been
   reached through both ``late_victims`` (yarn) and ``winning`` (bino).
4. Profile: the bino card run once more under ``torch.profiler`` —
   device time by kernel and the device's busy share of the run's wall
   time.
5. Print one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and the
   result line ``{"ok": true, "device": {...}}`` last.

Without a CUDA device, or outside a checkout of the repository, it exits
non-zero before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Main-path scenario: 1,000 nodes x 8 containers, 20 concurrent terasort
# jobs of 25 GB (200 maps + 32 reduces each, 4 splits per worker),
# submitted 1 s apart; a node crash in job 0 and a lost map output in
# job 1; 240 simulated seconds.
N_WORKERS = 1000
N_CONTAINERS = 8
N_JOBS = 20
JOB_GB = 25.0
SIM_TIME_CAP = 240.0
CAPTURE_AT = 120.0          # kernel-phase snapshot: mid-run

# Card peaks for bound_ms (NVIDIA H100 SXM data sheet): HBM3 bandwidth
# and the float64 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12

WARMUP, REPS = 3, 50
ADVERSARIAL_SEEDS = 8


def scenario(policy: str, backend, *, n_workers: int = N_WORKERS,
             n_jobs: int = N_JOBS, gb: float = JOB_GB,
             cap: float = SIM_TIME_CAP):
    """One seeded run of the main-path scenario through the port's
    public entry points; returns (sim, launches, result key, wall s)."""
    from repro_torch.sim import JobSpec, Simulation, faults
    from repro_torch.sim.mapreduce import BINO_PARAMS, SimParams

    base = BINO_PARAMS if policy == "bino" else SimParams()
    sim = Simulation(policy=policy, seed=0, n_workers=n_workers,
                     n_containers=N_CONTAINERS, assess_backend=backend,
                     params=dataclasses.replace(base, sim_time_cap=cap),
                     record_actions=True)
    launches = []
    orig = sim._start_attempt

    def logged(req, node_id):
        launches.append((sim.engine.now, req.task.task_id, node_id,
                         req.reason, req.speculative, req.rollback))
        return orig(req, node_id)

    sim._start_attempt = logged
    jobs = [sim.submit(JobSpec(f"j{i}", "terasort", gb,
                               submit_time=float(i)))
            for i in range(n_jobs)]
    faults.crash_busiest_node_at_map_progress(sim, jobs[0], 0.4)
    faults.lose_mof_at_map_progress(sim, jobs[1], 1.0)
    t0 = time.perf_counter()
    results = sim.run()
    wall = time.perf_counter() - t0
    key = [(r.job_id, r.finish_time, r.n_attempts, r.n_spec_attempts,
            r.n_fetch_failures) for r in results]
    return sim, launches, key, wall


def capture_snapshot(cap: float = CAPTURE_AT, **kw):
    """Run the bino scenario on numpy to mid-run and keep the state and
    arguments of the first Eq. 2 sample taken at or after ``CAPTURE_AT``
    (before its scratch write-back)."""
    from repro_torch.accel.numpy_backend import NumpyBackend
    from repro_torch.core.arrays import snapshot_state

    got = {}

    class Capture(NumpyBackend):
        def spatial_hits(self, arr, now, active, neighborhoods):
            got.setdefault("nh", neighborhoods)
            return super().spatial_hits(arr, now, active, neighborhoods)

        def temporal_zeta(self, arr, now, active, samp_flag, init_flag,
                          prevk):
            if "state" not in got and now >= CAPTURE_AT \
                    and samp_flag.any():
                got.update(state=snapshot_state(arr), now=now,
                           active=list(active), samp=samp_flag.copy(),
                           init=init_flag.copy(), prevk=prevk.copy())
            return super().temporal_zeta(arr, now, active, samp_flag,
                                         init_flag, prevk)

    sim, _l, _k, _w = scenario("bino", Capture(), cap=cap + 10.0, **kw)
    if "state" not in got:
        raise RuntimeError("no Eq. 2 sample after the capture time")
    got["win_factor"] = sim.speculator.collective.cfg.win_factor
    return got


def kernel_inputs(cap_state, device):
    """The four kernels' arguments at the main path's shapes, built by the
    backend itself from the captured snapshot on ``device``."""
    from repro_torch.accel.torch_backend import TorchBackend
    from repro_torch.core.arrays import snapshot_from_state

    arr = snapshot_from_state(cap_state["state"])
    now, active = cap_state["now"], cap_state["active"]
    backend = TorchBackend(device)
    return {
        "spatial": backend.spatial_args(arr, now, active, cap_state["nh"]),
        "temporal": backend.temporal_args(
            arr, now, active, cap_state["samp"], cap_state["init"],
            cap_state["prevk"])[0],
        "late": backend.late_args(arr, now, active, 10.0, 25.0,
                                  cap_state["win_factor"]),
        "reap": backend.reap_args(arr, now),
    }


def adversarial_inputs(seed: int, device, cap: int = 4096, n: int = 256,
                       jcap: int = 8, now: float = 100.0):
    """Kernel arguments built to expose summation order and tie handling:

    - spatial: one running row per (job, phase, node) bucket, so P is the
      row's ρ, drawn per group from two values {a, b}; a node whose own
      P is the smaller value sits exactly on Eq. 1's boundary
      (mean − σ = a in exact arithmetic), where the rounding of the
      k-sums decides; some buckets stay empty (NaN);
    - temporal: many rows per (job, node) bucket with values whose float
      sum depends on the order;
    - late and reap: task segments of one to three attempts, progress
      and start times from small sets (ties between attempts and between
      tasks), random speculative flags and attempt states."""
    rng = np.random.default_rng(seed)
    i32 = np.int32

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    ks = np.arange(4) - 2
    nh = ((np.arange(n)[:, None] + ks[None, :]) % n).astype(i32)
    # spatial
    bucket = rng.permutation(jcap * 2 * n)[:cap]
    s_job, rest = np.divmod(bucket, 2 * n)
    s_kind, s_node = np.divmod(rest, n)
    pair = rng.uniform(0.0, 1.0, (jcap * 2, 2))
    pick = rng.integers(0, 2, cap)
    s_rho = pair[s_job * 2 + s_kind, pick]
    s_run = (rng.random(cap) < 0.9).astype(i32)
    spatial = (t(s_rho), t(s_node.astype(i32)), t(s_kind.astype(i32)),
               t(s_job.astype(i32)), t(s_run), t(nh), jcap)
    # temporal
    vals = np.array([0.1, 0.2, 0.3, 0.7, 1e-3, 0.9999999])
    tm_node = rng.integers(0, n // 8, cap).astype(i32)
    tm_job = rng.integers(0, jcap, cap).astype(i32)
    tm_alive = (rng.random(cap) < 0.8).astype(i32)
    temporal = (t(rng.choice(vals, cap)), t(rng.choice(vals, cap)),
                t(tm_node), t(tm_job), t(tm_alive), jcap, n)
    # late / reap: canonical rows grouped into task segments
    sizes = rng.integers(1, 4, cap)
    tseg = np.repeat(np.arange(cap), sizes)[:cap].astype(i32)
    task_job = rng.integers(0, jcap, cap)
    jls = task_job[tseg].astype(i32)
    prog = rng.choice([0.0, 0.1, 0.25, 0.5, 0.75, 1.0], cap)
    start = rng.choice([0.0, 20.0, 50.0, 85.0, 95.0], cap)
    rate = prog / np.maximum(now - start, 1e-9)
    spec = (rng.random(cap) < 0.25).astype(i32)
    running = (rng.random(cap) < 0.7).astype(i32)
    runatt = np.maximum(running, rng.random(cap) < 0.1).astype(i32)
    order = rng.permutation(cap).astype(i32)
    q = float(rng.choice([10.0, 25.0, 50.0, 90.0]))
    late = (t(prog), t(start), t(rate), t(spec), t(tseg), t(jls),
            t(running), t(runatt), t(order), now, 10.0, q, 1.0, jcap)
    a_state = rng.choice(4, cap, p=[0.5, 0.3, 0.1, 0.1]).astype(i32)
    live = (rng.random(cap) < 0.6).astype(i32)
    reap = (t(a_state), t(tseg), t(live))
    return {"spatial": spatial, "temporal": temporal, "late": late,
            "reap": reap}


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _compare(a, b):
    """(equal, max_abs_err) with NaN equal to NaN, exact otherwise."""
    equal, err = True, 0.0
    for x, y in zip(_as_tuple(a), _as_tuple(b)):
        x, y = x.cpu(), y.cpu()
        if x.dtype != y.dtype or x.shape != y.shape:
            return False, float("inf")
        if x.is_floating_point():
            nx, ny = torch.isnan(x), torch.isnan(y)
            same_nan = torch.equal(nx, ny)
            x0, y0 = torch.where(nx, 0.0, x), torch.where(ny, 0.0, y)
            equal &= same_nan and torch.equal(x0, y0)
            if not same_nan:
                err = float("inf")
            elif x0.numel():
                err = max(err, float((x0 - y0).abs().max()))
        else:
            equal &= torch.equal(x, y)
            if x.numel():
                err = max(err, float((x.long() - y.long()).abs().max()))
    return equal, err


def _time_ms(fn, args) -> float:
    for _ in range(WARMUP):
        fn(*args)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(REPS):
        fn(*args)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / REPS


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _as_tuple(x)
               if isinstance(t, torch.Tensor))


def _ops(name, args) -> float:
    """Arithmetic and comparison operations the function needs on these
    inputs (float64, so against the non-tensor-core rate)."""
    if name == "spatial":
        running, nh, jcap = args[4], args[5], args[6]
        n, k = nh.shape
        return 2 * float(running.sum()) + jcap * 2 * n * (6 * k + 6)
    if name == "temporal":
        alive, jcap, n = args[4], args[5], args[6]
        return 3 * float(alive.sum()) + jcap * n
    if name == "late":
        # per row: a max and two rate maxima; per job: the rank count over
        # its m candidate tasks (2 m^2 comparisons), m taken from the tasks
        # with running attempts, an upper bound of the candidates.
        tseg, jls, running = args[4], args[5], args[6]
        cap = tseg.shape[0]
        run = running.bool()
        key = jls.long()[run] * cap + tseg.long()[run]
        segs = torch.unique(key)
        m = torch.bincount(segs // cap)
        return 4.0 * cap + 2 * float((m.double() ** 2).sum())
    return 2.0 * args[0].shape[0]


def kernel_phase(cap_state):
    from repro_torch.accel import kernels as K
    from repro_torch.accel import torch_backend as TB

    fns = {"spatial": (TB.spatial, TB.spatial_ref),
           "temporal": (TB.temporal, TB.temporal_ref),
           "late": (TB.late, TB.late_ref),
           "reap": (TB.reap, TB.reap_ref)}
    replaces = {
        "spatial": "src/repro/accel/pallas_backend.py:51 _spatial_kernel",
        "temporal": "src/repro/accel/pallas_backend.py:85 _temporal_kernel",
        "late": "src/repro/accel/pallas_backend.py:112 _late_kernel",
        "reap": "src/repro/accel/pallas_backend.py:191 _reap_kernel",
    }
    # Boundary cases first: every kernel equal to its plain version on
    # inputs built to expose summation order and tie handling.
    for seed in range(ADVERSARIAL_SEEDS):
        dev_adv = adversarial_inputs(seed, "cuda")
        cpu_adv = adversarial_inputs(seed, "cpu")
        for name, (wrapper, plain) in fns.items():
            equal, err = _compare(wrapper(*dev_adv[name]),
                                  plain(*cpu_adv[name]))
            if not equal:
                raise RuntimeError(f"{name}: kernel != plain version on "
                                   f"adversarial seed {seed} "
                                   f"(max_abs_err {err})")
    torch.cuda.synchronize()
    print(f"adversarial inputs: all kernels equal to their plain versions "
          f"({ADVERSARIAL_SEEDS} seeds)", flush=True)

    dev_in = kernel_inputs(cap_state, "cuda")
    cpu_in = kernel_inputs(cap_state, "cpu")
    rows = {}
    for name, (wrapper, plain) in fns.items():
        args = dev_in[name]
        before = K.launches[name]
        got = wrapper(*args)
        torch.cuda.synchronize()
        if K.launches[name] != before + 1:
            raise RuntimeError(f"{name}: the wrapper did not launch")
        want = plain(*cpu_in[name])
        equal, err = _compare(got, want)
        if not equal:
            raise RuntimeError(f"{name}: kernel != plain version "
                               f"(max_abs_err {err})")
        ms = _time_ms(wrapper, args)
        plain_ms = _time_ms(plain, args)
        in_bytes = sum(_nbytes(a) for a in args)
        bytes_ = in_bytes + _nbytes(got)
        ops = _ops(name, args)
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP64_OPS_PER_S * 1e3
        rows[name] = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/accel/csrc/assess.cu",
            "replaces": replaces[name], "launches": 0,
            "equal": True, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "bytes": bytes_, "ops": ops,
        }
        print(f"kernel {name}: equal max_abs_err={err} ms={ms:.6f} "
              f"plain_ms={plain_ms:.6f} bytes={bytes_}", flush=True)
    return rows


def main_path():
    """Bino then yarn, card and numpy each; returns per-kernel launches
    summed over the two card runs."""
    from repro_torch.accel import kernels as K
    from repro_torch.accel.torch_backend import TorchBackend

    b3_by = {"late_victims": 0, "winning": 0}
    for meth in b3_by:
        orig = getattr(TorchBackend, meth)

        def counted(self, *a, _orig=orig, _meth=meth, **kw):
            before = K.launches["late"]
            out = _orig(self, *a, **kw)
            b3_by[_meth] += K.launches["late"] - before
            return out
        setattr(TorchBackend, meth, counted)

    total = {name: 0 for name in K.launches}
    for policy in ("bino", "yarn"):
        K.reset_launches()
        card, c_launch, c_key, c_wall = scenario(policy, None)
        counts = dict(K.launches)
        ref, r_launch, r_key, r_wall = scenario(policy, "numpy")
        if not isinstance(card.speculator.backend, TorchBackend) \
                or card.speculator.backend.device.type != "cuda":
            raise RuntimeError("the default backend is not torch on cuda")
        if card.action_trace != ref.action_trace:
            raise RuntimeError(f"{policy}: action traces differ")
        if c_launch != r_launch:
            raise RuntimeError(f"{policy}: attempt launches differ")
        if c_key != r_key:
            raise RuntimeError(f"{policy}: job results differ")
        if not card.action_trace:
            raise RuntimeError(f"{policy}: no actions, nothing probed")
        for name in total:
            total[name] += counts[name]
        print(f"main path {policy}: identical traces "
              f"({len(card.action_trace)} actions, {len(c_launch)} "
              f"attempt launches, {len(c_key)} jobs finished); "
              f"card: {card.assess_ticks} assess ticks, assess_wall "
              f"{card.assess_wall:.6f} s, wall {c_wall:.6f} s, "
              f"{card.assess_ticks / card.assess_wall:.3f} ticks/s; "
              f"numpy: {ref.assess_ticks} ticks, assess_wall "
              f"{ref.assess_wall:.6f} s, wall {r_wall:.6f} s, "
              f"{ref.assess_ticks / ref.assess_wall:.3f} ticks/s; "
              f"kernel launches {counts}", flush=True)
    missing = [name for name, c in total.items() if c == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the main path: "
                           f"{missing}")
    if not (b3_by["late_victims"] > 0 and b3_by["winning"] > 0):
        raise RuntimeError(f"B3 not reached through both callers: {b3_by}")
    print(f"B3 launches by caller: {b3_by}", flush=True)
    return total


def profile_bino() -> None:
    """Device time by kernel over one bino card run, and the device's
    busy share of its wall time (the sum of kernel and copy times, which
    do not overlap on one stream)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim, _l, _k, wall = scenario("bino", None)
        torch.cuda.synchronize()
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == cuda)
    print(f"profile bino: wall {wall:.6f} s (profiled), assess_wall "
          f"{sim.assess_wall:.6f} s, {sim.assess_ticks} ticks, device busy "
          f"{dev_us / 1e6:.6f} s = {dev_us / 1e6 / wall:.6f} of wall")
    print(events.table(sort_by="self_device_time_total", row_limit=15,
                       max_name_column_width=60), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.accel import kernels as K

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    lib = K.build()
    K.library()
    print(f"built {lib.name} in {time.perf_counter() - t0:.3f} s",
          flush=True)

    cap_state = capture_snapshot()
    rows = kernel_phase(cap_state)
    launches = main_path()
    profile_bino()
    for name, row in rows.items():
        row["launches"] = launches[name]
    print(json.dumps({"kernels": list(rows.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
