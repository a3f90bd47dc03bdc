"""Synthetic production workloads.

``pacman_workload`` (§IV.D): the PACMan job-size mix with Poisson
arrivals — 85 % of jobs at 1 GB, 8 % at 10 GB, 5 % at 50 GB, 2 % at
100 GB, over Terasort/Wordcount/Secondarysort/Grep.

``fleet_workload`` (DESIGN.md §19): the multi-tenant dispatch plane's stress
mix — a heavier tail (rank^-alpha size frequencies over eight sizes up
to 100 GB) with *bursty* arrivals from a two-phase Markov-modulated
Poisson process: the arrival rate alternates between a burst phase
(``burst_factor`` × the base rate) and an idle phase, with
exponentially distributed phase lengths. Hundreds of concurrent jobs
at realistic burstiness instead of a memoryless trickle.

``trace_workload``: replay ``(time, gb[, bench])`` rows from a real
trace as JobSpecs.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.sim.job import JobSpec

PACMAN_SIZES = (1.0, 10.0, 50.0, 100.0)
PACMAN_PROBS = (0.85, 0.08, 0.05, 0.02)
STRESS_BENCHES = ("terasort", "wordcount", "secondarysort", "grep")


def pacman_workload(n_jobs: int, *, mean_interarrival: float = 30.0,
                    seed: int = 0,
                    benches: Sequence[str] = STRESS_BENCHES,
                    start: float = 0.0) -> List[JobSpec]:
    rng = np.random.default_rng(seed)
    t = start
    jobs = []
    for i in range(n_jobs):
        t += float(rng.exponential(mean_interarrival))
        size = float(rng.choice(PACMAN_SIZES, p=PACMAN_PROBS))
        bench = str(rng.choice(list(benches)))
        jobs.append(JobSpec(job_id=f"j{i:04d}", bench=bench,
                            input_gb=size, submit_time=t))
    return jobs


# Heavy-tailed size grid for the fleet mix: P(size rank r) ∝ r^-alpha.
FLEET_SIZES = (0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0)
FLEET_ALPHA = 1.8


def _fleet_probs(alpha: float = FLEET_ALPHA) -> np.ndarray:
    w = np.arange(1, len(FLEET_SIZES) + 1, dtype=np.float64) ** -alpha
    return w / w.sum()


def fleet_workload(n_jobs: int, *, mean_interarrival: float = 10.0,
                   burst_factor: float = 8.0, burst_len: float = 120.0,
                   idle_len: float = 480.0, alpha: float = FLEET_ALPHA,
                   seed: int = 0, benches: Sequence[str] = STRESS_BENCHES,
                   start: float = 0.0) -> List[JobSpec]:
    """Heavy-tailed sizes + MMPP(2) bursty arrivals.

    Phase lengths are exponential(``burst_len``/``idle_len``); within a
    phase, gaps are exponential with mean ``mean_interarrival`` (idle)
    or ``mean_interarrival / burst_factor`` (burst). A gap that would
    cross the phase boundary is re-drawn from the boundary at the new
    phase's rate — valid because the exponential is memoryless.
    Deterministic for a given seed.
    """
    rng = np.random.default_rng(seed)
    probs = _fleet_probs(alpha)
    t = start
    in_burst = False
    phase_end = t + float(rng.exponential(idle_len))
    jobs = []
    for i in range(n_jobs):
        while True:
            mean = (mean_interarrival / burst_factor if in_burst
                    else mean_interarrival)
            gap = float(rng.exponential(mean))
            if t + gap <= phase_end:
                t += gap
                break
            t = phase_end
            in_burst = not in_burst
            phase_end = t + float(rng.exponential(
                burst_len if in_burst else idle_len))
        size = float(rng.choice(FLEET_SIZES, p=probs))
        bench = str(rng.choice(list(benches)))
        jobs.append(JobSpec(job_id=f"f{i:05d}", bench=bench,
                            input_gb=size, submit_time=t))
    return jobs


def trace_workload(trace: Sequence[Sequence], *, prefix: str = "t",
                   default_bench: str = "terasort",
                   n_reduces: Optional[int] = None) -> List[JobSpec]:
    """Map ``(submit_time, input_gb[, bench])`` trace rows to JobSpecs,
    sorted by submit time (real traces are not always ordered)."""
    jobs = []
    for i, row in enumerate(sorted(trace, key=lambda r: float(r[0]))):
        bench = str(row[2]) if len(row) > 2 else default_bench
        jobs.append(JobSpec(job_id=f"{prefix}{i:05d}", bench=bench,
                            input_gb=float(row[1]),
                            submit_time=float(row[0]),
                            n_reduces=n_reduces))
    return jobs
