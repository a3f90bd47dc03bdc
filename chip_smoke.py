#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing falls back):

1. Print the card (``nvidia-smi``), torch/CUDA versions, and build the
   kernels with ``nvcc``, one process per source, all started together
   (timed): B1–B4 from ``src/repro_torch/accel/csrc/assess.cu``, B5 from
   ``csrc/bulk.cu``, B6 from ``csrc/flash_attention.cu``, B7 and B8 from
   ``csrc/flash_attention_bwd.cu`` and B9 from ``csrc/decode_attention.cu``.
2. Kernel phase: each of B1–B5 on the card against its plain
   torch version on CPU copies of the same inputs, exactly (NaN equal to
   NaN) — first on :func:`adversarial_inputs` (summation-order, tie and
   padding boundary cases), then on a mid-run snapshot of the main-path
   scenario, where kernel and plain version are also timed on the card
   with CUDA events.
3. Main path: the 1,000-node, 20-job scenario under
   ``policy="bino"`` and ``policy="yarn"``, each once with the default
   backend (torch on the card) and once with ``assess_backend="numpy"``.
   Action traces, attempt launches and job results must be
   byte-identical, and every kernel must have launched during the card
   runs; B3 must have been reached through both ``late_victims`` (yarn)
   and ``winning`` (bino).
4. Fair path: the same jobs on the ε-fair network with 40
   racks, the kernel shuffle engine and drain-boundary re-pricing, plus a
   rack switch degrade — bino with assessment and the bulk solver on the
   card, then both on numpy. Byte-identical traces, launches and results;
   B5 launched and transfers re-priced. B5 is then held against its plain
   version on every pricing call of the card run and timed.
5. Sweep path: the fair card run's snapshot at 120 s, 64 fault
   scenarios of all five kinds; ``BatchedSweep.run_batched`` on the card
   (one launch each of B1, B3 and B4 with a scenario axis) equals
   ``run_serial`` on numpy exactly. The batched kernels are then held
   against their plain versions and against 64 per-scenario launches,
   and timed.
6. Profile: the flat bino card run once more under
   ``torch.profiler`` — device time by kernel and the device's busy share
   of the run's wall time.
7. Attention kernels: B6 (flash-attention forward) and
   B9 (decode attention) against their plain torch versions on the card,
   in bf16 and f32, on boundary inputs (sq < sk, ragged tiles, a window,
   groups 1, 4 and 48, head_dim 64 and 128, valid lengths at 1, at tile
   edges ±1 and at the cache size), within the tolerances of
   ``tests/test_kernels.py`` (bf16 2e-2, f32 2e-5; lse 2e-5); then at the
   serving path's shapes, timed beside the plain versions and
   ``F.scaled_dot_product_attention`` (the yardstick only: the port never
   calls it).
8. Serving path: Qwen3-8B at full width (36 layers, random
   bf16 weights from a seeded generator) serves 4 prompts of 2,048 token
   ids through ``make_prefill_step`` and 64 greedy steps of
   ``make_serve_step``: exactly 36 B6 and 2,304 B9 launches, no
   plain-version call. The logits of the prefill and of decode steps 1,
   16 and 64 are held against the port's ``forward`` with ``impl="ref"``
   in float32 over the same prefix; an fp8 cast of the activations must
   fail the same tolerance. The same bf16 prefill on the oracles shows
   how much of the error is bf16 rounding. Prints prefill ms, decode ms
   per step, tokens/s, peak device memory, and a profile of the device
   time by kernel.
9. Attention backward: B7 (dK, dV) and B8 (dQ) against
   their plain versions on the card in bf16 and f32 on boundary inputs
   (causal or not, windows, sq < sk, ragged tiles, groups 1, 4 and 8,
   head_dim 64 and 128; bf16 2e-2, f32 2e-5), the f32 gradient of the
   op against autograd of the oracle (1e-3); then at Qwen1.5-0.5B's layer
   shape and Qwen3-8B's head layout, timed beside the plain versions and
   the backward of ``scaled_dot_product_attention`` (dq, dk and dv in
   one call; the yardstick only).
10. Training path: Qwen1.5-0.5B at full width and depth
   (random bf16 weights from seed 0) trained by ``TrainerRuntime`` under
   the binocular-speculation coordinator, 4 hosts x 4 microbatches of
   2,048 tokens: a warm-up step and 5 timed steps (wall, tokens/s, loss,
   peak memory, the reports' detections, recoveries and executed
   microbatches); B6, B7 and B8 each launched exactly 24 times per
   ``grad_fn`` call, no plain-version call, B1–B4 launched on the bino
   ticks. Step 0's loss and one microbatch's gradients are held against
   float32 autograd through the oracles (a probe that zeroes B8's dq
   must fail the gradient limit), and that microbatch's gradients
   computed twice must be byte-identical. The same steps then run under
   the pinned ``crash`` script with bino (checkpointing every 2 steps)
   and with gang restart, and a fresh runtime resumes from the bino run's
   last checkpoint before the end: each must end byte-identical to the
   fault-free run, and the crash runs must show a recovery. The last
   resumed step is profiled (device time by kernel, busy share).
11. Print one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and
   the result line ``{"ok": true, "device": {...}}`` last.

Each path is driven with the launch counts set to 0 just before it and
read just after; the comparisons of phases 2, 4, 5, 7 and 9 and the
training checks launch outside those windows.

Without a CUDA device, or outside a checkout of the repository, it exits
non-zero before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import os
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
CAPTURE_AT = 120.0          # kernel-phase and sweep snapshots: mid-run
# Fair path: benchmarks/perf_net.py's rack count at 1,000 nodes,
# max(2, n // 25); rack 3's uplink degrades to 5 % for 90 s from 60 s.
N_RACKS = 40
DEGRADE = dict(rack=3, at=60.0, factor=0.05, duration=90.0)
N_SCENARIOS = 64

# Card peaks for bound_ms (NVIDIA H100 SXM data sheet): HBM3 bandwidth,
# the float64 and float32 rates outside the tensor cores, and the dense
# bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

# Serving path: Qwen3-8B at full width, 4 prompts of 2,048 tokens, a
# 4,096-slot cache, 64 greedy decode steps; logits checked after the
# prefill and at these decode steps.
SERVE_ARCH = "qwen3-8b"
SERVE_SEED = 0
SERVE_BATCH = 4
SERVE_PROMPT = 2048
SERVE_MAX_LEN = 4096
SERVE_STEPS = 64
SERVE_CHECKS = (1, 16, 64)
# Serving tolerance: max |port - reference| over the reference logits'
# RMS. The port runs in bf16 (weights, activations, KV cache; f32 sums
# inside every product and norm), the reference in f32 from the same
# bf16 weights; bf16 keeps 8 significant bits, so each rounding moves a
# value by up to 2^-9 of itself, and 36 layers of residual adds, norms
# and products compound that. Measured on an H100 80GB HBM3 at 700 W
# (PERF.md): the prefill and decode steps 1, 16, 64 at 0.099-0.119; the
# probe below at 0.449. The limit sits between, 1.7x above the bf16 run
# and 2.2x below the probe: the same prefill with the activations
# entering every attention and MLP block and the head cast to fp8 (e4m3,
# 4 significant bits) must exceed it, so the check catches a silent drop
# to fp8.
SERVE_TOL = 0.2
# Attention kernels vs their plain versions (tests/test_kernels.py:21-23)
ATTN_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
LSE_TOL = 2e-5

WARMUP, REPS = 3, 50
ADVERSARIAL_SEEDS = 8


def scenario(policy: str, backend, *, n_workers: int = N_WORKERS,
             n_jobs: int = N_JOBS, gb: float = JOB_GB,
             cap: float = SIM_TIME_CAP, shuffle: str = "batch",
             net: str = "flat", racks: int = 0, net_opts=None,
             degrade=None):
    """One seeded run of the main-path scenario through the port's
    public entry points; returns (sim, launches, result key, wall s).
    ``net``/``racks``/``net_opts``/``shuffle`` select the network and
    engine, ``degrade`` adds a rack switch degrade."""
    from repro_torch.sim import JobSpec, Simulation, faults
    from repro_torch.sim.mapreduce import BINO_PARAMS, SimParams

    base = BINO_PARAMS if policy == "bino" else SimParams()
    sim = Simulation(policy=policy, seed=0, n_workers=n_workers,
                     n_containers=N_CONTAINERS, assess_backend=backend,
                     params=dataclasses.replace(base, sim_time_cap=cap),
                     shuffle=shuffle, net=net, racks=racks,
                     net_opts=net_opts, record_actions=True)
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
    if degrade is not None:
        faults.rack_switch_degrade_at(sim, **degrade)
    t0 = time.perf_counter()
    results = sim.run()
    wall = time.perf_counter() - t0
    key = [(r.job_id, r.finish_time, r.n_attempts, r.n_spec_attempts,
            r.n_fetch_failures) for r in results]
    return sim, launches, key, wall


def fair_scenario(assess, bulk, *, racks: int = N_RACKS, **kw):
    """The main-path jobs and faults on the ε-fair network: ``racks``
    racks, the kernel shuffle engine, drain-boundary re-pricing of
    in-flight transfers, and a rack switch degrade; bino."""
    return scenario("bino", assess, shuffle="kernel", net="fair",
                    racks=racks, net_opts={"realloc": True,
                                           "bulk_backend": bulk},
                    degrade=DEGRADE, **kw)


def timed_bulk(base, *args, prices=None):
    """An instance of bulk backend class ``base`` that adds the host wall
    time of its water-fill and pricing calls (each returns host arrays,
    so the device work is inside) to ``.wall``, and appends every
    non-empty pricing call's inputs to ``prices`` when given."""

    class Timed(base):
        def waterfill(self, eff, links, valid, eps):
            t0 = time.perf_counter()
            out = super().waterfill(eff, links, valid, eps)
            self.wall["waterfill"] += time.perf_counter() - t0
            return out

        def price(self, share, links, valid):
            if prices is not None and len(links):
                prices.append((share.copy(), links.copy(), valid.copy()))
            t0 = time.perf_counter()
            out = super().price(share, links, valid)
            self.wall["price"] += time.perf_counter() - t0
            return out

    bulk = Timed(*args)
    bulk.wall = {"waterfill": 0.0, "price": 0.0}
    return bulk


def recording_backends(device, at: float = CAPTURE_AT):
    """Torch assessment and bulk backends on ``device`` that record: the
    snapshot at the first spatial pass at or after ``at``, and every
    pricing call's inputs (the bulk backend is :func:`timed_bulk`).
    Returns (assess, bulk, record dict)."""
    from repro_torch.accel.bulk import TorchBulk
    from repro_torch.accel.torch_backend import TorchBackend
    from repro_torch.core.arrays import snapshot_state

    got = {"prices": []}

    class Assess(TorchBackend):
        def spatial_hits(self, arr, now, active, neighborhoods):
            if "state" not in got and now >= at:
                got.update(state=snapshot_state(arr), now=now)
            return super().spatial_hits(arr, now, active, neighborhoods)

    return Assess(device), timed_bulk(TorchBulk, device,
                                      prices=got["prices"]), got


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
            "reap": reap, "price": price_inputs(rng, n, device)}


def price_inputs(rng, n: int, device, racks: int = 8):
    """B5's arguments padded as ``TorchBulk.price`` pads them, with
    ``k`` just above a power of two: shares from a small set with ties
    and values below 1.0 (the max with 1.0 decides), one-link local
    flows, two-link intra-rack and four-link inter-rack flows, valid
    flags off the leading slots, -1 ids under invalid flags, and
    all-invalid pad rows."""
    nL = 2 * n + racks
    k = 2 ** int(rng.integers(6, 12)) + 1
    cap = 16
    while cap < k:
        cap *= 2
    share = rng.choice([0.25, 0.5, 1.0, 1.5, 3.0, 1e9], nL)
    links = rng.integers(0, nL, (cap, 4)).astype(np.int32)
    width = rng.choice([1, 2, 4], cap)
    valid = np.arange(4)[None, :] < width[:, None]
    shuffled = rng.random(cap) < 0.2            # flags off the prefix
    valid[shuffled] = rng.permuted(valid[shuffled], axis=1)
    valid[k:] = False
    links[~valid & (rng.random((cap, 4)) < 0.5)] = -1

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return t(share), t(links), t(valid)


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
                # equal entries (infinities included) differ by 0
                d = torch.where(x0 == y0, 0.0, (x0 - y0).abs())
                err = max(err, float(d.max()))
        else:
            equal &= torch.equal(x, y)
            if x.numel():
                err = max(err, float((x.long() - y.long()).abs().max()))
    return equal, err


def _time_ms(fn, args, reps: int = REPS) -> float:
    for _ in range(WARMUP):
        fn(*args)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn(*args)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _as_tuple(x)
               if isinstance(t, torch.Tensor))


# Leading row arguments of the kernels that take a scenario axis.
ROW_ARGS = {"spatial": 5, "late": 9, "reap": 3}


def one_scenario(name: str, args: tuple, s: int) -> tuple:
    """Scenario ``s``'s arguments of batched kernel ``name``: its rows of
    the stacked row arguments, the shared arguments as they are."""
    k = ROW_ARGS[name]
    return tuple(a[s] for a in args[:k]) + tuple(args[k:])


def _ops(name, args) -> float:
    """Arithmetic and comparison operations the function needs on these
    inputs (float64, so against the non-tensor-core rate)."""
    if name.endswith("_sweep"):
        base = name[:-len("_sweep")]
        return sum(_ops(base, one_scenario(base, args, s))
                   for s in range(args[0].shape[0]))
    if name == "price":
        # a compare per valid link and the max with 1.0 per row
        return float(args[2].sum()) + args[1].shape[0]
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


REPLACES = {
    "spatial": "src/repro/accel/pallas_backend.py:51 _spatial_kernel",
    "temporal": "src/repro/accel/pallas_backend.py:85 _temporal_kernel",
    "late": "src/repro/accel/pallas_backend.py:112 _late_kernel",
    "reap": "src/repro/accel/pallas_backend.py:191 _reap_kernel",
}


def kernel_phase(cap_state):
    from repro_torch.accel import kernels as K
    from repro_torch.accel import torch_backend as TB

    fns = {"spatial": (TB.spatial, TB.spatial_ref),
           "temporal": (TB.temporal, TB.temporal_ref),
           "late": (TB.late, TB.late_ref),
           "reap": (TB.reap, TB.reap_ref)}
    # Boundary cases first: every kernel equal to its plain version on
    # inputs built to expose summation order and tie handling.
    from repro_torch.accel import bulk as B
    adv_fns = dict(fns, price=(B.price, B.price_ref))
    for seed in range(ADVERSARIAL_SEEDS):
        dev_adv = adversarial_inputs(seed, "cuda")
        cpu_adv = adversarial_inputs(seed, "cpu")
        for name, (wrapper, plain) in adv_fns.items():
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
        rows[name] = timed_row(name, wrapper, plain, args, got, err,
                               "src/repro_torch/accel/csrc/assess.cu",
                               REPLACES[name])
    return rows


def timed_row(name, wrapper, plain, args, got, err, source, replaces):
    """The kernel's line of the ``{"kernels": ...}`` record: kernel and
    plain version timed on the card on ``args``, and the bound for
    them (bytes of the inputs read once and the outputs written once
    over the memory rate, or operations over the float64 rate)."""
    ms = _time_ms(wrapper, args)
    plain_ms = _time_ms(plain, args)
    bytes_ = sum(_nbytes(a) for a in args) + _nbytes(got)
    ops = _ops(name, args)
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP64_OPS_PER_S * 1e3
    print(f"kernel {name}: equal max_abs_err={err} ms={ms:.6f} "
          f"plain_ms={plain_ms:.6f} bytes={bytes_}", flush=True)
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": 0,
        "equal": True, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "bytes": bytes_, "ops": ops,
    }


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

    total = {name: 0 for name in ("spatial", "temporal", "late", "reap")}
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


def fair_path():
    """Bino on the ε-fair network, card then numpy; returns the card
    run's launch counts and its records (pricing calls, snapshot)."""
    from repro_torch.accel import kernels as K

    from repro_torch.accel.bulk import NumpyBulk

    assess, bulk, got = recording_backends("cuda")
    K.reset_launches()
    card, c_launch, c_key, c_wall = fair_scenario(assess, bulk)
    counts = dict(K.launches)
    ref_bulk = timed_bulk(NumpyBulk)
    ref, r_launch, r_key, r_wall = fair_scenario("numpy", ref_bulk)
    if card.action_trace != ref.action_trace:
        raise RuntimeError("fair: action traces differ")
    if c_launch != r_launch:
        raise RuntimeError("fair: attempt launches differ")
    if c_key != r_key:
        raise RuntimeError("fair: job results differ")
    if not card.action_trace:
        raise RuntimeError("fair: no actions, nothing probed")
    if counts["price"] == 0 or len(got["prices"]) != counts["price"]:
        raise RuntimeError(f"fair: B5 launched {counts['price']} times for "
                           f"{len(got['prices'])} pricing calls")
    if card.shuffle.n_reallocs == 0:
        raise RuntimeError("fair: no transfer was re-priced")
    if "state" not in got:
        raise RuntimeError("fair: no snapshot at the sweep time")
    net, ref_net = card.cluster.net, ref.cluster.net
    print(f"fair path bino ({N_WORKERS} nodes, {N_RACKS} racks): identical "
          f"traces ({len(card.action_trace)} actions, {len(c_launch)} "
          f"attempt launches, {len(c_key)} jobs finished); re-priced "
          f"transfers {card.shuffle.n_reallocs}; card: water-fill calls "
          f"{bulk.n_calls}, rounds {bulk.n_rounds}, wall "
          f"{bulk.wall['waterfill']:.6f} s, pricing calls {bulk.n_prices}, "
          f"wall {bulk.wall['price']:.6f} s, solver recomputes "
          f"{net.n_recomputes}, {card.assess_ticks} assess ticks, "
          f"assess_wall "
          f"{card.assess_wall:.6f} s, "
          f"{card.assess_ticks / card.assess_wall:.3f} ticks/s, wall "
          f"{c_wall:.6f} s; numpy: solver recomputes "
          f"{ref_net.n_recomputes}, water-fill wall "
          f"{ref_bulk.wall['waterfill']:.6f} s, pricing wall "
          f"{ref_bulk.wall['price']:.6f} s, re-priced "
          f"{ref.shuffle.n_reallocs}, "
          f"{ref.assess_ticks} ticks, assess_wall {ref.assess_wall:.6f} s, "
          f"{ref.assess_ticks / ref.assess_wall:.3f} ticks/s, wall "
          f"{r_wall:.6f} s; kernel launches {counts}", flush=True)
    return counts, got


def price_phase(prices):
    """B5 against its plain version on every pricing call of the fair
    card run, as ``TorchBulk.price`` pads them; timed on the largest."""
    from repro_torch.accel import bulk as B

    err, largest = 0.0, None
    for share, links, valid in prices:
        cpu = tuple(torch.from_numpy(x)
                    for x in (share, *B.pad_flows(links, valid)))
        dev = tuple(x.cuda() for x in cpu)
        equal, e = _compare(B.price(*dev), B.price_ref(*cpu))
        if not equal:
            raise RuntimeError(f"price: kernel != plain version on a "
                               f"recorded call (k {len(links)}, "
                               f"max_abs_err {e})")
        err = max(err, e)
        if largest is None or dev[1].shape[0] > largest[1].shape[0]:
            largest = dev
    got = B.price(*largest)
    print(f"price: kernel equal to its plain version on {len(prices)} "
          f"recorded calls (largest cap {largest[1].shape[0]}, nL "
          f"{largest[0].shape[0]})", flush=True)
    return timed_row("price", B.price, B.price_ref, largest, got, err,
                     "src/repro_torch/accel/csrc/bulk.cu",
                     "src/repro/accel/bulk.py:252 "
                     "PallasBulk._price_core.kernel")


def sweep_path(state, now, device="cuda", n_scen=N_SCENARIOS,
               racks=N_RACKS):
    """The batched sweep on the fair run's snapshot: ``run_batched`` on
    ``device`` against ``run_serial`` on numpy, every scenario and field
    exactly. Returns (the sweep, launch counts of the batched call)."""
    from repro_torch.accel import kernels as K
    from repro_torch.accel.sweep import BatchedSweep, scenario_grid
    from repro_torch.core.arrays import snapshot_from_state

    arr = snapshot_from_state(state)
    grid = scenario_grid(n_scen, len(arr.node_ids), seed=1, n_racks=racks)
    kinds = sorted({sc.kind for sc in grid})
    if len(kinds) != 5:
        raise RuntimeError(f"sweep: scenario kinds {kinds}, expected 5")
    sweep = BatchedSweep(arr, now).prepare(grid)
    K.reset_launches()
    batched = sweep.run_batched(device)
    counts = dict(K.launches)
    serial = sweep.run_serial()
    for i, (b, r) in enumerate(zip(batched, serial)):
        for field in r:
            if not np.array_equal(np.asarray(b[field]),
                                  np.asarray(r[field])):
                raise RuntimeError(f"sweep: scenario {i} ({grid[i].kind}) "
                                   f"field {field} differs from serial")
    if len(batched) != len(serial) or len(serial) != n_scen:
        raise RuntimeError("sweep: scenario count differs")
    if device != "cpu":
        want = {"spatial_sweep": 1, "late_sweep": 1, "reap_sweep": 1}
        seen = {k: counts[k] for k in want}
        if seen != want:
            raise RuntimeError(f"sweep: launches {seen}, expected {want}")

    def ms(fn, reps=3):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3

    batched_ms = ms(lambda: sweep.run_batched(device))
    serial_ms = ms(sweep.run_serial)
    summary = {
        "victims": sum(int((r["late_victims"] >= 0).sum()) for r in serial),
        "spatial_hits": sum(int(r["spatial_hits"].sum()) for r in serial),
        "failed": sum(int(r["failed"].sum()) for r in serial),
        "winning": sum(int(r["winning"].sum()) for r in serial),
        "n_reap": sum(r["n_reap"] for r in serial)}
    print(f"sweep path: {n_scen} scenarios ({', '.join(kinds)}) at "
          f"t={now} on {arr.n} rows, {len(sweep.active)} jobs: run_batched "
          f"equal to run_serial in every field; totals {summary}; "
          f"batched {batched_ms:.3f} ms, serial {serial_ms:.3f} ms per "
          f"sweep; kernel launches {counts}", flush=True)
    return sweep, counts


def batched_kernel_phase(sweep):
    """B1, B3 and B4 with the scenario axis on the sweep's own inputs:
    equal to the plain versions on CPU copies and to one N = 1 launch
    per scenario; timed."""
    from repro_torch.accel import torch_backend as TB

    dev_args, _cols = sweep.kernel_args("cuda")
    cpu_args, _cols = sweep.kernel_args("cpu")
    fns = {"spatial": (TB.spatial, TB.spatial_ref),
           "late": (TB.late, TB.late_ref),
           "reap": (TB.reap, TB.reap_ref)}
    rows = {}
    for name, (wrapper, plain) in fns.items():
        args = dev_args[name]
        got = wrapper(*args)
        equal, err = _compare(got, plain(*cpu_args[name]))
        if not equal:
            raise RuntimeError(f"{name}_sweep: kernel != plain version "
                               f"(max_abs_err {err})")
        n = args[0].shape[0]
        singles = [wrapper(*one_scenario(name, args, s)) for s in range(n)]
        if isinstance(got, tuple):
            singles = tuple(torch.stack(x) for x in zip(*singles))
        else:
            singles = torch.stack(singles)
        equal, _err = _compare(got, singles)
        if not equal:
            raise RuntimeError(f"{name}_sweep: batched launch != {n} "
                               f"single-scenario launches")
        rows[name + "_sweep"] = timed_row(
            name + "_sweep", wrapper, plain, args, got, err,
            "src/repro_torch/accel/csrc/assess.cu",
            f"{REPLACES[name]} (scenario axis: the vmap of "
            f"src/repro/accel/sweep.py:138)")
    return rows


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


# ---------------------------------------------------------------------------
# Attention kernels B6 and B9
# ---------------------------------------------------------------------------
# Boundary inputs: (b, sq, sk, hq, hkv, d, causal, window) for B6 and
# (b, S, hq, hkv, d, valid lengths) for B9. No row is left without an
# unmasked key (B6's plain version masks with -1e30, the oracle with -inf).
FLASH_CASES = [
    (1, 100, 300, 4, 1, 64, True, 0),      # sq < sk (q_offset 200), ragged
    (2, 130, 130, 8, 2, 128, True, 0),     # sq not a multiple of the tile
    (1, 200, 300, 48, 1, 128, True, 64),   # a group of 48, a window
    (2, 64, 64, 4, 4, 64, False, 0),       # group 1, not causal
    (1, 77, 256, 32, 8, 128, False, 40),   # a window without the band
]
DECODE_CASES = [
    (5, 300, 4, 4, 64, (1, 63, 64, 65, 300)),     # group 1, tile edges
    (4, 4096, 32, 8, 128, (1, 127, 129, 4096)),   # group 4, valid at S
    (3, 256, 48, 1, 128, (128, 255, 256)),        # a group of 48
]
FLASH_SOURCE = "src/repro_torch/accel/csrc/flash_attention.cu"
DECODE_SOURCE = "src/repro_torch/accel/csrc/decode_attention.cu"
FLASH_REPLACES = ("src/repro/kernels/flash_attention/flash_attention.py:38 "
                  "_fwd_kernel (pallas_call :141)")
DECODE_REPLACES = ("src/repro/kernels/decode_attention/decode_attention.py"
                   ":28 _decode_kernel (pallas_call :108)")


def _randn(seed: int, dtype, *shapes):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for shape in shapes]


def _within(what: str, got, want, tol: float) -> float:
    """max |got - want|; raises unless |got - want| <= tol + tol |want|
    everywhere (NaN where both are NaN counts as equal)."""
    got, want = got.float(), want.float()
    both_nan = torch.isnan(got) & torch.isnan(want)
    diff = torch.where(both_nan, 0.0, (got - want).abs())
    ok = bool((diff <= tol + tol * want.abs().nan_to_num()).all())
    err = float(diff.max()) if diff.numel() else 0.0
    if not ok or err != err:
        raise RuntimeError(f"{what}: kernel vs plain version max_abs_err "
                           f"{err}, tolerance {tol}")
    return err


def _causal_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps for one (sequence, head)."""
    rows = torch.arange(sq)[:, None] + (sk - sq)
    cols = torch.arange(sk)[None, :]
    keep = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        keep &= cols <= rows
    if window:
        keep &= cols > rows - window
    return int(keep.sum())


def _attn_row(name, ms, plain_ms, library_ms, bytes_, ops, dtype, err,
              source, replaces):
    rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    print(f"kernel {name}: max_abs_err={err} ms={ms:.6f} plain_ms="
          f"{plain_ms:.6f} library_ms={library_ms:.6f} bytes={bytes_} "
          f"ops={ops}", flush=True)
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": 0, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms, "bytes": bytes_, "ops": ops,
    }


def attention_kernel_phase():
    """B6 and B9 against their plain versions on boundary inputs, then at
    the serving path's shapes, timed beside the plain versions and
    ``scaled_dot_product_attention`` (the yardstick)."""
    import torch.nn.functional as F

    from repro_torch.accel import kernels as K
    from repro_torch.kernels.decode_attention import decode_attention as DA
    from repro_torch.kernels.flash_attention import flash_attention as FA

    seed = 0
    for dtype in (torch.float32, torch.bfloat16):
        tol = ATTN_TOL[dtype]
        for case in FLASH_CASES:
            b, sq, sk, hq, hkv, d, causal, window = case
            q, k, v = _randn(seed, dtype, (b, sq, hq, d), (b, sk, hkv, d),
                             (b, sk, hkv, d))
            seed += 1
            out, lse = FA.flash_attention_fwd(q, k, v, causal=causal,
                                              window=window)
            pout, plse = FA.flash_attention_plain(q, k, v, causal=causal,
                                                  window=window)
            _within(f"flash_fwd {case} {dtype} out", out, pout, tol)
            _within(f"flash_fwd {case} {dtype} lse", lse, plse, LSE_TOL)
        for case in DECODE_CASES:
            b, S, hq, hkv, d, valid = case
            q, k, v = _randn(seed, dtype, (b, hq, d), (b, S, hkv, d),
                             (b, S, hkv, d))
            seed += 1
            vl = torch.tensor(valid, dtype=torch.int32, device="cuda")
            _within(f"decode {case} {dtype}",
                    DA.decode_attention_fwd(q, k, v, vl),
                    DA.decode_attention_plain(q, k, v, vl), tol)
    torch.cuda.synchronize()
    print(f"attention boundary inputs: B6 ({len(FLASH_CASES)} cases) and B9 "
          f"({len(DECODE_CASES)} cases) within tolerance of their plain "
          f"versions in float32 and bf16", flush=True)

    cfg_b, cfg_s, hq, hkv, d = (SERVE_BATCH, SERVE_PROMPT, 32, 8, 128)
    bf16 = torch.bfloat16
    rows = {}
    # B6 at the prefill shape
    q, k, v = _randn(100, bf16, (cfg_b, cfg_s, hq, d), (cfg_b, cfg_s, hkv, d),
                     (cfg_b, cfg_s, hkv, d))
    before = K.launches["flash_fwd"]
    out, lse = FA.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    if K.launches["flash_fwd"] != before + 1:
        raise RuntimeError("flash_fwd: the wrapper did not launch")
    pout, plse = FA.flash_attention_plain(q, k, v)
    err = _within("flash_fwd at the prefill shape", out, pout,
                  ATTN_TOL[bf16])
    _within("flash_fwd lse at the prefill shape", lse, plse, LSE_TOL)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def sdpa_prefill():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    lib_err = float((sdpa_prefill().transpose(1, 2).float()
                     - out.float()).abs().max())
    pairs = _causal_pairs(cfg_s, cfg_s, True, 0)
    rows["flash_fwd"] = _attn_row(
        "flash_fwd", _time_ms(FA.flash_attention_fwd, (q, k, v)),
        _time_ms(FA.flash_attention_plain, (q, k, v), reps=5),
        _time_ms(sdpa_prefill, ()),
        sum(_nbytes(x) for x in (q, k, v, out, lse)),
        4.0 * cfg_b * hq * d * pairs, bf16, err, FLASH_SOURCE,
        FLASH_REPLACES)
    print(f"flash_fwd vs scaled_dot_product_attention: max_abs_err "
          f"{lib_err}", flush=True)
    del q, k, v, out, lse, pout, plse, qt, kt, vt

    # B9 at the decode shape: a 4,096-slot cache filled to 2,100
    n = 2100
    q, k, v = _randn(101, bf16, (cfg_b, hq, d), (cfg_b, SERVE_MAX_LEN, hkv, d),
                     (cfg_b, SERVE_MAX_LEN, hkv, d))
    vl = torch.full((cfg_b,), n, dtype=torch.int32, device="cuda")
    before = K.launches["decode"]
    out = DA.decode_attention_fwd(q, k, v, vl)
    torch.cuda.synchronize()
    if K.launches["decode"] != before + 1:
        raise RuntimeError("decode: the wrapper did not launch")
    err = _within("decode at the serving shape", out,
                  DA.decode_attention_plain(q, k, v, vl), ATTN_TOL[bf16])
    q4 = q[:, :, None].contiguous()
    k4, v4 = (x[:, :n].transpose(1, 2).contiguous() for x in (k, v))

    def sdpa_decode():
        return F.scaled_dot_product_attention(q4, k4, v4, enable_gqa=True)

    lib_err = float((sdpa_decode()[:, :, 0].float() - out.float())
                    .abs().max())
    kv_bytes = 2 * cfg_b * n * hkv * d * k.element_size()
    rows["decode"] = _attn_row(
        "decode", _time_ms(DA.decode_attention_fwd, (q, k, v, vl)),
        _time_ms(DA.decode_attention_plain, (q, k, v, vl), reps=10),
        _time_ms(sdpa_decode, ()),
        _nbytes(q) + kv_bytes + _nbytes(vl) + _nbytes(out),
        4.0 * cfg_b * hq * d * n, bf16, err, DECODE_SOURCE, DECODE_REPLACES)
    print(f"decode vs scaled_dot_product_attention: max_abs_err {lib_err}",
          flush=True)
    return rows


# ---------------------------------------------------------------------------
# Serving path: Qwen3-8B at full width
# ---------------------------------------------------------------------------
class _CountCalls:
    """Counts calls of ``module.name`` for each (module, name) pair while
    the ``with`` block runs; restores them after."""

    def __init__(self, targets):
        self.targets = targets
        self.calls = {}

    def __enter__(self):
        self._saved = []
        for mod, name in self.targets:
            orig = getattr(mod, name)
            key = f"{mod.__name__}.{name}"
            self.calls[key] = 0

            def counted(*a, _orig=orig, _key=key, **kw):
                self.calls[_key] += 1
                return _orig(*a, **kw)
            setattr(mod, name, counted)
            self._saved.append((mod, name, orig))
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self._saved:
            setattr(mod, name, orig)
        return False


def _rel_err(got, ref) -> float:
    """max |got - ref| over the RMS of ``ref``."""
    ref = ref.float()
    rms = float(ref.pow(2).mean().sqrt())
    return float((got.float() - ref).abs().max()) / rms


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def serve_path(cfg=None, device="cuda"):
    """Qwen3-8B at full width (or ``cfg``): prefill 4 x 2,048 tokens, then
    64 greedy decode steps, through the port's serving entry points, on
    ``device`` (a CPU run rehearses the path on the plain versions, with
    no launch to count). Returns the launch counts of the run."""
    from repro_torch.accel import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention as DA
    from repro_torch.kernels.decode_attention import ref as DREF
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ref as FREF
    from repro_torch.models import layers as L
    from repro_torch.models import model as PM
    from repro_torch.train.loop import (TrainConfig, make_prefill_step,
                                        make_serve_step)

    # the f32 reference must be f32: no TF32 in products or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg or get_config(SERVE_ARCH)
    on_card = torch.device(device).type == "cuda"
    B, P = SERVE_BATCH, SERVE_PROMPT
    t0 = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(SERVE_SEED)
    params = PM.init_params(cfg, gen, device=device)
    _sync(device)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in params.parameters())
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in params.parameters())
    rng = np.random.default_rng(SERVE_SEED)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, P))
                               .astype(np.int32)).to(device)
    tc = TrainConfig()
    prefill_step = make_prefill_step(cfg, tc, max_len=SERVE_MAX_LEN)
    serve_step = make_serve_step(cfg, tc)
    print(f"serve: {SERVE_ARCH} {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
          f"{n_params} parameters ({weight_bytes} bytes, bf16), init "
          f"{init_s:.3f} s", flush=True)

    # warm-up on a short prompt (library handles, allocator), uncounted
    w = min(64, P // 2)
    _l, warm = make_prefill_step(cfg, tc, max_len=w + 1)(
        params, {"tokens": prompts[:, :w]})
    serve_step(params, warm, prompts[:, w], torch.full(
        (B,), w, dtype=torch.int32, device=device))
    del warm
    _sync(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    plain = _CountCalls([(FA, "flash_attention_plain"),
                         (DA, "decode_attention_plain"),
                         (FREF, "attention_reference"),
                         (DREF, "decode_attention_reference")])
    K.reset_launches()
    with plain:
        t0 = time.perf_counter()
        logits0, cache = prefill_step(params, {"tokens": prompts})
        _sync(device)
        prefill_s = time.perf_counter() - t0
        after_prefill = dict(K.launches)
        tok = logits0.argmax(-1).to(torch.int32)
        inputs, checks = [tok], {}
        pos = torch.full((B,), P, dtype=torch.int32, device=device)
        t0 = time.perf_counter()
        for step in range(1, SERVE_STEPS + 1):
            logits, cache = serve_step(params, cache, tok, pos)
            if step in SERVE_CHECKS:
                checks[step] = logits.float()
            tok = logits.argmax(-1).to(torch.int32)
            inputs.append(tok)
            pos = pos + 1
        _sync(device)
        decode_s = time.perf_counter() - t0
    counts = dict(K.launches)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    L_ = cfg.n_layers if on_card else 0
    want_prefill = {"flash_fwd": L_, "decode": 0}
    want = {"flash_fwd": L_, "decode": L_ * SERVE_STEPS}
    if {k: after_prefill[k] for k in want_prefill} != want_prefill:
        raise RuntimeError(f"serve: prefill launches {after_prefill}, "
                           f"expected {want_prefill}")
    others = {k: c for k, c in counts.items() if k not in want and c}
    if {k: counts[k] for k in want} != want or others:
        raise RuntimeError(f"serve: launches {counts}, expected {want}")
    if on_card and any(plain.calls.values()):
        raise RuntimeError(f"serve: plain versions called on the card's "
                           f"path: {plain.calls}")
    print(f"serve: prefill {B} x {P} tokens {prefill_s * 1e3:.3f} ms "
          f"({B * P / prefill_s:.1f} tokens/s); decode {SERVE_STEPS} steps "
          f"{decode_s * 1e3 / SERVE_STEPS:.3f} ms/step "
          f"({B * SERVE_STEPS / decode_s:.1f} tokens/s); peak device memory "
          f"{peak} bytes; kernel launches {counts}; plain-version calls "
          f"{plain.calls}", flush=True)
    del cache

    # Correctness: logits against the port's forward with impl="ref" in
    # float32 over the same prefix (each layer's weights upcast as it
    # runs; the head for the last position only).
    seq = torch.cat([prompts] + [t[:, None] for t in inputs[:-1]], dim=1)
    got = {"prefill": (P, logits0)}
    got.update((f"decode step {k}", (P + k, checks[k]))
               for k in SERVE_CHECKS)
    errs, refs = {}, {}
    with torch.no_grad():
        for label, (n, port) in got.items():
            ref = PM.forward(cfg, params, {"tokens": seq[:, :n]},
                             impl="ref", compute_dtype=torch.float32,
                             last_only=True)[0][:, 0]
            if port.shape != (B, cfg.vocab_size) or \
                    not bool(torch.isfinite(port).all()):
                raise RuntimeError(f"serve: {label} logits not finite of "
                                   f"shape {(B, cfg.vocab_size)}")
            refs[label] = ref
            errs[label] = _rel_err(port, ref)
        # the probe: fp8 activations into every block and the head
        orig = L.apply_norm

        def fp8_norm(c, p, x):
            y = orig(c, p, x)
            return y.to(torch.float8_e4m3fn).to(y.dtype)

        L.apply_norm = fp8_norm
        try:
            probe, _c = PM.prefill(cfg, params, {"tokens": prompts})
        finally:
            L.apply_norm = orig
        del _c
        fp8_err = _rel_err(probe, refs["prefill"])
        # where the error comes from: the same bf16 prefill on the oracles
        oracle, _c = PM.prefill(cfg, params, {"tokens": prompts},
                                impl="ref")
        del _c
    print(f"serve: logits vs the f32 reference, max|diff|/rms: "
          f"{json.dumps(errs)}; tolerance {SERVE_TOL}; fp8-activation "
          f"probe {fp8_err}; bf16 prefill on the oracles vs the f32 "
          f"reference {_rel_err(oracle, refs['prefill'])}, vs the "
          f"kernels' prefill {_rel_err(logits0, oracle)}", flush=True)
    bad = {k: e for k, e in errs.items() if not e <= SERVE_TOL}
    if bad:
        raise RuntimeError(f"serve: logits outside tolerance {SERVE_TOL}: "
                           f"{bad}")
    if not fp8_err > SERVE_TOL:
        raise RuntimeError(f"serve: the fp8 probe ({fp8_err}) passes the "
                           f"tolerance {SERVE_TOL}: it is too loose")
    agree = float((refs["prefill"].argmax(-1).int() == inputs[0])
                  .float().mean())
    print(f"serve: greedy first token equal to the reference's argmax for "
          f"{agree:.2f} of the batch", flush=True)

    if on_card:
        profile_serve(params, prompts, prefill_step, serve_step)
    return counts


def profile_serve(params, prompts, prefill_step, serve_step,
                  steps: int = 8) -> None:
    """Device time by kernel, and the device's busy share of the wall
    time, for one prefill and, apart, ``steps`` decode steps."""
    from torch.profiler import ProfilerActivity, profile

    B, P = prompts.shape
    cuda = torch.autograd.DeviceType.CUDA
    state = {}

    def prefill():
        state["logits"], state["cache"] = prefill_step(
            params, {"tokens": prompts})

    def decode():
        tok = state["logits"].argmax(-1).to(torch.int32)
        pos = torch.full((B,), P, dtype=torch.int32, device="cuda")
        for _ in range(steps):
            logits, state["cache"] = serve_step(params, state["cache"], tok,
                                                pos)
            tok = logits.argmax(-1).to(torch.int32)
            pos = pos + 1

    for label, fn in (("prefill", prefill), (f"{steps} decode steps",
                                              decode)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        dev_us = sum(e.self_device_time_total for e in events
                     if e.device_type == cuda)
        print(f"profile serve {label}: wall {wall:.6f} s (profiled), device "
              f"busy {dev_us / 1e6:.6f} s = {dev_us / 1e6 / wall:.6f} of "
              f"wall")
        print(events.table(sort_by="self_device_time_total", row_limit=12,
                           max_name_column_width=60), flush=True)


# ---------------------------------------------------------------------------
# Attention backward kernels B7 and B8
# ---------------------------------------------------------------------------
# Boundary inputs: (b, sq, sk, hq, hkv, d, causal, window); every query row
# keeps at least one key.
BWD_CASES = [
    (1, 100, 300, 4, 1, 64, True, 0),      # sq < sk, ragged, a group of 4
    (2, 130, 130, 8, 8, 128, True, 0),     # group 1, sq = sk off the tile
    (1, 200, 300, 16, 2, 128, True, 64),   # a group of 8, a window
    (2, 64, 64, 4, 4, 64, False, 0),       # not causal
    (1, 77, 256, 32, 8, 128, False, 40),   # a window without the band
    (1, 96, 96, 8, 1, 64, True, 16),       # a group of 8, a narrow window
]
# The f32 kernels against autograd of the oracle (tests/test_kernels.py:
# 83-90): 1e-3.
BWD_ORACLE_TOL = 1e-3
# Training shapes: Qwen1.5-0.5B's layer (the main path), then Qwen3-8B's
# head layout: (b, s, hq, hkv, d), causal, bf16.
BWD_SHAPES = {"qwen1.5-0.5b": (1, 2048, 16, 16, 64),
              "qwen3-8b": (1, 4096, 32, 8, 128)}
BWD_SOURCE = "src/repro_torch/accel/csrc/flash_attention_bwd.cu"
DKV_REPLACES = ("src/repro/kernels/flash_attention/flash_attention.py:169 "
                "_dkv_kernel (pallas_call :322)")
DQ_REPLACES = ("src/repro/kernels/flash_attention/flash_attention.py:235 "
               "_dq_kernel (pallas_call :361)")


def _bwd_case(seed, dtype, b, sq, sk, hq, hkv, d, causal, window):
    """q, k, v, dO and the forward's out and lse (B6 on the card)."""
    from repro_torch.kernels.flash_attention import flash_attention as FA

    q, k, v, do = _randn(seed, dtype, (b, sq, hq, d), (b, sk, hkv, d),
                         (b, sk, hkv, d), (b, sq, hq, d))
    out, lse = FA.flash_attention_fwd(q, k, v, causal=causal, window=window)
    return q, k, v, do, lse, FA.bwd_delta(out, do)


def attention_bwd_phase():
    """B7 and B8 against their plain versions on boundary inputs in bf16
    and f32, the f32 gradient against autograd of the oracle, then at the
    training shapes, timed beside the plain versions and the backward of
    ``scaled_dot_product_attention`` (the yardstick: dq, dk and dv in one
    call)."""
    import torch.nn.functional as F

    from repro_torch.accel import kernels as K
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ops as FOPS
    from repro_torch.kernels.flash_attention import ref as FREF

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 oracle is f32
    torch.backends.cudnn.allow_tf32 = False
    seed, worst = 200, {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = ATTN_TOL[dtype]
        for case in BWD_CASES:
            args = _bwd_case(seed, dtype, *case)
            q, k, v, do = args[:4]
            seed += 1
            causal, window = case[6], case[7]
            dk, dv = K.launch_flash_dkv(*args, causal, window,
                                        q.shape[-1] ** -0.5)
            dq = K.launch_flash_dq(*args, causal, window, q.shape[-1] ** -0.5)
            pdk, pdv = FA.flash_attention_dkv_plain(*args, causal=causal,
                                                    window=window)
            pdq = FA.flash_attention_dq_plain(*args, causal=causal,
                                              window=window)
            for name, got, want in (("dk", dk, pdk), ("dv", dv, pdv),
                                    ("dq", dq, pdq)):
                err = _within(f"flash bwd {case} {dtype} {name}", got, want,
                              tol)
                worst[(dtype, name)] = max(worst.get((dtype, name), 0.0),
                                           err)
            if dtype == torch.float32:
                # the op's gradient against autograd of the oracle
                leaves = [x.clone().requires_grad_() for x in (q, k, v)]
                got = torch.autograd.grad(FOPS.flash_attention(
                    *leaves, causal=causal, window=window), leaves, do)
                want = torch.autograd.grad(FREF.attention_reference(
                    *leaves, causal=causal, window=window), leaves, do)
                for name, g, w in zip(("dq", "dk", "dv"), got, want):
                    _within(f"flash bwd {case} {name} vs the oracle", g, w,
                            BWD_ORACLE_TOL)
    torch.cuda.synchronize()
    errs = {f"{dtype} {name}": e for (dtype, name), e in worst.items()}
    print(f"attention backward boundary inputs: B7 and B8 ({len(BWD_CASES)} "
          f"cases) within tolerance of their plain versions in float32 and "
          f"bf16 (max_abs_err {errs}), f32 within {BWD_ORACLE_TOL} of "
          f"autograd of the oracle", flush=True)

    rows, bf16 = {}, torch.bfloat16
    for arch, (b, s, hq, hkv, d) in BWD_SHAPES.items():
        args = _bwd_case(300, bf16, b, s, s, hq, hkv, d, True, 0)
        q, k, v, do = args[:4]
        scale = d ** -0.5
        before = (K.launches["flash_dkv"], K.launches["flash_dq"])
        dk, dv = K.launch_flash_dkv(*args, True, 0, scale)
        dq = K.launch_flash_dq(*args, True, 0, scale)
        torch.cuda.synchronize()
        if (K.launches["flash_dkv"], K.launches["flash_dq"]) != \
                (before[0] + 1, before[1] + 1):
            raise RuntimeError("flash bwd: the wrappers did not launch")
        pdk, pdv = FA.flash_attention_dkv_plain(*args)
        pdq = FA.flash_attention_dq_plain(*args)
        err_kv = max(_within(f"flash_dkv at {arch}'s shape dk", dk, pdk,
                             ATTN_TOL[bf16]),
                     _within(f"flash_dkv at {arch}'s shape dv", dv, pdv,
                             ATTN_TOL[bf16]))
        err_q = _within(f"flash_dq at {arch}'s shape", dq, pdq,
                        ATTN_TOL[bf16])
        del pdk, pdv, pdq
        # the yardstick: SDPA's backward for dq, dk and dv together
        qt, kt, vt = (x.transpose(1, 2).detach().clone().requires_grad_()
                      for x in (q, k, v))
        o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True)
        do_t = do.transpose(1, 2)

        def sdpa_bwd():
            return torch.autograd.grad(o_lib, (qt, kt, vt), do_t,
                                       retain_graph=True)

        lib_err = max(float((g.transpose(1, 2).float() - w.float()).abs()
                            .max()) for g, w in zip(sdpa_bwd(),
                                                    (dq, dk, dv)))
        library_ms = _time_ms(sdpa_bwd, ())
        pairs = _causal_pairs(s, s, True, 0)
        flops = 2.0 * b * hq * d * pairs    # one product
        in_bytes = sum(_nbytes(x) for x in args)
        dkv = _attn_row(
            "flash_dkv", _time_ms(K.launch_flash_dkv, (*args, True, 0,
                                                       scale)),
            _time_ms(FA.flash_attention_dkv_plain, args, reps=3),
            library_ms, in_bytes + _nbytes((dk, dv)), 4 * flops, bf16,
            err_kv, BWD_SOURCE, DKV_REPLACES)
        dq_row = _attn_row(
            "flash_dq", _time_ms(K.launch_flash_dq, (*args, True, 0, scale)),
            _time_ms(FA.flash_attention_dq_plain, args, reps=3),
            library_ms, in_bytes + _nbytes(dq), 3 * flops, bf16, err_q,
            BWD_SOURCE, DQ_REPLACES)
        print(f"flash bwd at {arch}'s layout (b {b}, s {s}, {hq}/{hkv} heads, "
              f"d {d}, causal, bf16): B7 {dkv['ms']:.6f} ms (bound "
              f"{dkv['bound_ms']:.6f}, {dkv['bound_by']}), B8 "
              f"{dq_row['ms']:.6f} ms (bound {dq_row['bound_ms']:.6f}); "
              f"B7 + B8 {dkv['ms'] + dq_row['ms']:.6f} ms against SDPA's "
              f"backward {library_ms:.6f} ms (max_abs_err vs B7/B8 "
              f"{lib_err})", flush=True)
        if not rows:    # the main path's shape names the rows
            rows = {"flash_dkv": dkv, "flash_dq": dq_row}
        del q, k, v, do, args, dk, dv, dq, qt, kt, vt, o_lib
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Training path: Qwen1.5-0.5B at full width through the live runtime
# ---------------------------------------------------------------------------
# Qwen1.5-0.5B (configs/qwen1_5_0_5b.py) at full width and depth, random
# bf16 weights from seed 0, TrainConfig() defaults; 4 hosts x 4
# microbatches of 1 x 2,048 tokens (32,768 tokens a step) under bino with
# compute_delay 0 and the columnar/reference differential on; one
# warm-up step, then TRAIN_STEPS timed ones.
TRAIN_ARCH = "qwen1.5-0.5b"
TRAIN_SEED = 0
TRAIN_SEQ = 2048
TRAIN_HOSTS = 4
TRAIN_MB = 4
TRAIN_STEPS = 5
# The first step's loss and one microbatch's gradients are held against
# float32 autograd through the oracles (impl="ref") on the same batch and
# the same (bf16-valued) weights. The port trains in bf16 (weights,
# activations, gradients), with float32 sums inside every product and
# norm and a float32 loss.
# - TRAIN_LOSS_TOL bounds |loss - reference| / |reference| of step 0;
#   measured on an H100 80GB HBM3 at 700 W (PERF.md): 1.2e-4.
# - TRAIN_GRAD_TOL bounds the largest ||g - ref|| / ||ref|| over the
#   leaves; measured 0.022 (a K bias of a late layer). A probe must
#   exceed it: the same gradients with B8's dq replaced by zeros, which
#   zeroes every layer's wq and bq gradient (measured 1.0). The limit sits
#   2.3x above the measurement and 20x below the probe.
TRAIN_LOSS_TOL = 1e-3
TRAIN_GRAD_TOL = 0.05
# A host thread ends at its next check after shutdown, at most one
# microbatch's gradient away.
HOST_EXIT_S = 120.0


def _host_calls(trainer):
    """Count every host's grad_fn calls, across threads."""
    import threading

    lock, count = threading.Lock(), [0]
    for host in trainer.coord.hosts.values():
        def counted(params, batch, _orig=host.grad_fn):
            with lock:
                count[0] += 1
            return _orig(params, batch)
        host.grad_fn = counted
    return count


def _param_bytes(params) -> torch.Tensor:
    """Every parameter's bits, in tree order, as one byte tensor."""
    from repro_torch.models import layers as L

    return torch.cat([t.detach().reshape(-1).view(torch.uint8)
                      for t in L.tree_leaves(params).values()])


def _print_reports(label, reports, tokens):
    for r in reports:
        detections = sum("declared" in x or "timed out" in x
                         for x in r.recoveries)
        print(f"train {label}: step {r.step} wall {r.wall_s:.6f} s "
              f"({tokens / r.wall_s:.1f} tokens/s) loss "
              f"{r.metrics.get('loss', float('nan')):.6f} mb_executed "
              f"{r.mb_executed}/{r.mb_needed} restarts {r.restarts} "
              f"wedges {r.wedges} detections {detections} recoveries "
              f"{len(r.recoveries)} {r.recoveries[:4]}", flush=True)


def _leaf_errors(got, want):
    """{path: ||got - want|| / ||want||}."""
    return {k: float((got[k].float() - want[k].float()).norm()
                     / want[k].float().norm()) for k in want}


def _same_bits(a, b) -> bool:
    return a.dtype == b.dtype and torch.equal(a.view(torch.uint8),
                                              b.view(torch.uint8))


def train_checks(cfg, params0, batches, device):
    """On the initial weights and step 0's batches: float32 losses through
    the oracles; microbatch 0's gradients on the kernels twice (byte
    identity), through the oracles in float32 (the reference), and with
    B8's dq replaced by zeros (the probe)."""
    from repro_torch.accel import kernels as K
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.models import layers as L
    from repro_torch.models import model as PM
    from repro_torch.train.loop import (TrainConfig, cross_entropy_loss,
                                        make_grad_fn)

    with torch.no_grad():
        ref_losses = [float(cross_entropy_loss(PM.forward(
            cfg, params0, b, impl="ref", compute_dtype=torch.float32)[0],
            b["labels"])) for b in batches]
    grad = make_grad_fn(cfg, TrainConfig())
    g1, _m = grad(params0, batches[0])
    g2, _m = grad(params0, batches[0])
    differ = [k for k in g1 if not _same_bits(g1[k], g2[k])]
    del g2
    # the probe: B8's dq (or its plain version's, on the CPU) set to zeros
    target = (K, "launch_flash_dq") if device == "cuda" else \
        (FA, "flash_attention_dq_plain")
    orig = getattr(*target)
    setattr(*target, lambda q, *a, **kw: torch.zeros_like(q))
    try:
        gp, _m = grad(params0, batches[0])
    finally:
        setattr(*target, orig)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activation_dtype="float32")
    p32 = L.tree_from_leaves(params0, {k: v.detach().float() for k, v in
                                       L.tree_leaves(params0).items()},
                             trainable=True)
    gref, _m = make_grad_fn(cfg32, TrainConfig(impl="ref", remat="full"))(
        p32, batches[0])
    del p32
    errs, probe = _leaf_errors(g1, gref), _leaf_errors(gp, gref)
    worst = max(errs, key=errs.get)
    return {"ref_losses": ref_losses, "grad_err": errs[worst],
            "grad_worst_leaf": worst, "probe_err": max(probe.values()),
            "nondeterministic": differ}


def train_path(cfg=None, device="cuda", steps=TRAIN_STEPS, seq=TRAIN_SEQ,
               ckpt_root=None):
    """Qwen1.5-0.5B at full width (or ``cfg``) trained through
    ``TrainerRuntime`` on ``device``; checkpoints go to a temporary
    directory under ``ckpt_root`` (default: the repository's git-ignored
    ``build/``), removed at the end. Returns the fault-free timed steps'
    launch counts."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 references
    torch.backends.cudnn.allow_tf32 = False
    root = Path(ckpt_root or ROOT / "build")
    root.mkdir(parents=True, exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="train_ckpt_", dir=root)
    try:
        return _train_runs(cfg or get_config(TRAIN_ARCH), device, steps,
                           seq, ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def _train_runs(cfg, device, steps, seq, ckpt_dir):
    """The training path on ``device`` (a CPU run rehearses it on the
    plain versions, with no launch to count): fault-free, then under the
    pinned crash script with bino (checkpointing into ``ckpt_dir``) and
    gang restart, then resumed from a checkpoint."""
    import shutil

    from repro_torch.accel import kernels as K
    from repro_torch.accel.torch_backend import TorchBackend
    from repro_torch.data.pipeline import DataState
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ref as FREF
    from repro_torch.runtime import (PINNED_SCRIPTS, ChaosController,
                                     RuntimeConfig, TrainerRuntime)
    from repro_torch.train.loop import TrainConfig

    on_card = torch.device(device).type == "cuda"
    tokens = TRAIN_HOSTS * TRAIN_MB * seq
    n_steps = 1 + steps
    assess = None if on_card else TorchBackend("cpu")
    assess_keys = ("spatial", "temporal", "late", "reap")

    def runtime(recovery="bino", script=None, horizon=0.0, ckpt_every=None,
                **kw):
        """``ckpt_every``: None for no checkpoints, 0 to restore only."""
        rt = RuntimeConfig(
            n_hosts=TRAIN_HOSTS, microbatches_per_shard=TRAIN_MB,
            recovery=recovery, compute_delay=0.0,
            verify_columnar=recovery == "bino", assess_backend=assess,
            checkpoint_dir=None if ckpt_every is None else ckpt_dir,
            checkpoint_every=ckpt_every or 0, **kw)
        chaos = (ChaosController(PINNED_SCRIPTS[script], horizon=horizon,
                                 seed=7) if script else None)
        return TrainerRuntime(cfg, TrainConfig(), rt, seq_len=seq,
                              per_shard_batch=1, seed=TRAIN_SEED,
                              chaos=chaos, device=device)

    def finish(trainer, calls):
        """Shut the hosts down and wait for their threads to end (a losing
        speculative attempt may still be inside its backward), then read
        the launch counts and check them against the grad_fn calls."""
        trainer.shutdown()
        for host in trainer.coord.hosts.values():
            host.join(timeout=HOST_EXIT_S)
            if host.is_alive():
                raise RuntimeError(f"train: host {host.host_id} still "
                                   f"running {HOST_EXIT_S} s after shutdown")
        counts = dict(K.launches)
        want = cfg.n_layers * calls[0] if on_card else 0
        flash = {k: counts[k] for k in ("flash_fwd", "flash_dkv",
                                        "flash_dq")}
        if flash != dict.fromkeys(flash, want):
            raise RuntimeError(f"train: launches {flash}, expected {want} "
                               f"each ({cfg.n_layers} x {calls[0]} grad_fn "
                               f"calls)")
        return counts

    # -- fault-free ------------------------------------------------------
    t = runtime()
    print(f"train: {cfg.arch_id} {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
          f"{sum(p.numel() for p in t.state['params'].parameters())} "
          f"parameters; {TRAIN_HOSTS} hosts x {TRAIN_MB} microbatches of 1 "
          f"x {seq} tokens ({tokens} tokens a step)", flush=True)
    params0 = t.state["params"]
    batches = [t.coord.batch_fn(DataState(TRAIN_SEED, s, TRAIN_HOSTS, m))
               for s in range(TRAIN_HOSTS) for m in range(TRAIN_MB)]
    # The counts cover the whole run, warm-up included, up to the hosts'
    # shutdown: a losing speculative attempt may still be computing when
    # its step ends, so no instant between steps is free of launches.
    calls = _host_calls(t)
    plain = _CountCalls([(FA, "flash_attention_plain"),
                         (FA, "flash_attention_dkv_plain"),
                         (FA, "flash_attention_dq_plain"),
                         (FREF, "attention_reference")])
    K.reset_launches()
    w0 = time.perf_counter()
    with plain:
        warm = t.run(1)
        _print_reports("fault-free (warm-up)", warm, tokens)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        timed = t.run(steps)
        counts = finish(t, calls)
    ff_wall = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated() if on_card else None
    if on_card and any(plain.calls.values()):
        raise RuntimeError(f"train: plain versions called on the card's "
                           f"path: {plain.calls}")
    _print_reports("fault-free", timed, tokens)
    walls = [r.wall_s for r in timed]
    losses = [r.metrics["loss"] for r in warm + timed]
    print(f"train fault-free: {steps} timed steps after the warm-up, mean "
          f"wall {sum(walls) / len(walls):.6f} s "
          f"({tokens * len(walls) / sum(walls):.1f} tokens/s); losses "
          f"{losses}; peak device memory {peak} bytes; "
          f"{calls[0]} grad_fn calls (warm-up included); kernel launches "
          f"{counts}; "
          f"plain-version calls {plain.calls}; detections "
          f"{t.coord.metrics.counter('detections').n}, recoveries "
          f"{t.coord.metrics.counter('recoveries').n}, mb_executed "
          f"{[r.mb_executed for r in warm + timed]}", flush=True)
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"train: losses not finite: {losses}")
    final = _param_bytes(t.state["params"]).clone()
    ff_counts = counts
    assess_counts = {k: counts[k] for k in assess_keys}
    del t

    # -- loss, gradients, reproducibility (gates c-e) -------------------
    checks = train_checks(cfg, params0, batches, device)
    ref_loss = float(np.mean(checks["ref_losses"]))
    loss_err = abs(losses[0] - ref_loss) / abs(ref_loss)
    print(f"train checks: step 0 loss {losses[0]!r} vs float32 through the "
          f"oracles {ref_loss!r}, relative error {loss_err} (limit "
          f"{TRAIN_LOSS_TOL}); microbatch 0 gradients vs float32 autograd "
          f"through the oracles: max ||g - ref|| / ||ref|| "
          f"{checks['grad_err']} at {checks['grad_worst_leaf']} (limit "
          f"{TRAIN_GRAD_TOL}); the probe (B8's dq zeroed) "
          f"{checks['probe_err']}; leaves differing between two runs "
          f"{checks['nondeterministic']}", flush=True)
    if not loss_err <= TRAIN_LOSS_TOL:
        raise RuntimeError(f"train: step 0 loss off by {loss_err}")
    if not checks["grad_err"] <= TRAIN_GRAD_TOL:
        raise RuntimeError(f"train: gradients off by {checks['grad_err']}")
    if not checks["probe_err"] > TRAIN_GRAD_TOL:
        raise RuntimeError(f"train: the probe ({checks['probe_err']}) "
                           f"passes {TRAIN_GRAD_TOL}: it is too loose")
    if checks["nondeterministic"]:
        raise RuntimeError(f"train: gradients not reproducible: "
                           f"{checks['nondeterministic']}")
    del params0, batches

    # -- faults: bino (checkpointing) and gang restart --------------------
    # the crash fires at 0.2 of the horizon: a fifth into the run
    horizon = ff_wall
    for recovery in ("bino", "restart"):
        K.reset_launches()
        t = runtime(recovery, "crash", horizon,
                    ckpt_every=2 if recovery == "bino" else None)
        calls = _host_calls(t)
        reports = t.run(n_steps)
        counts = finish(t, calls)
        for k in assess_keys:
            assess_counts[k] += counts[k]
        _print_reports(f"{recovery} crash", reports, tokens)
        same = torch.equal(_param_bytes(t.state["params"]), final)
        print(f"train {recovery} crash (horizon {horizon:.3f} s): final "
              f"params {'byte-identical to' if same else 'DIFFER from'} "
              f"the fault-free run; {calls[0]} grad_fn calls; step walls "
              f"{[r.wall_s for r in reports]}; mb_executed "
              f"{[r.mb_executed for r in reports]}; kernel launches "
              f"{counts}", flush=True)
        if not same:
            raise RuntimeError(f"train: {recovery} crash run diverged")
        if not any(r.recoveries or r.restarts for r in reports):
            raise RuntimeError(f"train: {recovery} crash run shows no "
                               f"recovery")
        del t

    # -- resume from the bino run's last checkpoint before the end ------
    kept = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and "." not in d)
    start = max(k for k in kept if k < n_steps)
    for k in kept:
        if k > start:   # as if the run had died before writing them
            shutil.rmtree(os.path.join(ckpt_dir, f"step_{k:09d}"))
    t = runtime(ckpt_every=0)
    if t._start_step != start:
        raise RuntimeError(f"train: resumed at {t._start_step}, not {start}")
    calls = _host_calls(t)
    K.reset_launches()
    reports = t.run(n_steps - start - 1)
    # the last step profiled, after a step on the fresh host threads
    reports += profile_train(t) if on_card else t.run(1)
    finish(t, calls)
    same = torch.equal(_param_bytes(t.state["params"]), final)
    print(f"train resume: restored step {start} of the bino crash run "
          f"(checkpoints {kept}), ran steps {[r.step for r in reports]}: "
          f"final params {'byte-identical to' if same else 'DIFFER from'} "
          f"the fault-free run", flush=True)
    if not same:
        raise RuntimeError("train: the resumed run diverged")
    del t
    if on_card and not all(assess_counts.values()):
        raise RuntimeError(f"train: assessment kernels never launched on "
                           f"the bino ticks: {assess_counts}")
    print(f"train: assessment kernel launches on the bino ticks (fault-free "
          f"timed steps and both crash runs): {assess_counts}", flush=True)
    if on_card:
        torch.cuda.empty_cache()
    return ff_counts


def profile_train(trainer):
    """Device time by kernel over one training step, and the device's busy
    share of its wall time; returns the step's reports. Device activity
    only: recording every op of four host threads on the CPU side
    stretched a profiled step about fivefold."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        reports = trainer.run(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == cuda)
    print(f"profile train step: wall {wall:.6f} s (profiled), device busy "
          f"{dev_us / 1e6:.6f} s = {dev_us / 1e6 / wall:.6f} of wall")
    print(events.table(sort_by="self_device_time_total", row_limit=20,
                       max_name_column_width=60), flush=True)
    return reports


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
    libs = K.build()
    for name in libs:
        K.library(name)
    print(f"built {', '.join(p.name for p in libs.values())} in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    cap_state = capture_snapshot()
    rows = kernel_phase(cap_state)
    launches = main_path()
    fair_launches, fair = fair_path()
    launches["price"] = fair_launches["price"]
    rows["price"] = price_phase(fair["prices"])
    sweep, sweep_launches = sweep_path(fair["state"], fair["now"])
    launches.update((k, sweep_launches[k])
                    for k in ("spatial_sweep", "late_sweep", "reap_sweep"))
    rows.update(batched_kernel_phase(sweep))
    profile_bino()
    rows.update(attention_kernel_phase())
    serve_launches = serve_path()
    launches.update((k, serve_launches[k]) for k in ("flash_fwd", "decode"))
    rows.update(attention_bwd_phase())
    train_launches = train_path()
    launches.update((k, train_launches[k]) for k in ("flash_dkv",
                                                     "flash_dq"))
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
