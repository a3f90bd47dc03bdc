"""Experiment helpers shared by the paper-figure benchmarks.

``run_single`` runs one job under one policy with an optional fault
callback; ``baseline_jct`` caches fault-free runs; ``slowdown`` is the
paper's metric (JCT with fault / fault-free JCT, same policy-free
baseline).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.sim.job import JobResult, JobSpec
from repro_torch.sim.mapreduce import SimJob, SimParams, Simulation

FaultFn = Callable[[Simulation, SimJob], None]


def run_single(policy: str, spec: JobSpec, fault: Optional[FaultFn] = None,
               *, seed: int = 0, n_workers: int = 20, n_containers: int = 8,
               params: Optional[SimParams] = None,
               assess_backend: Optional[str] = None,
               policy_factory=None) -> JobResult:
    sim = Simulation(policy=policy, seed=seed, n_workers=n_workers,
                     n_containers=n_containers, params=params,
                     assess_backend=assess_backend,
                     policy_factory=policy_factory)
    job = sim.submit(spec)
    if fault is not None:
        fault(sim, job)
    results = sim.run()
    assert results, f"job did not finish within the sim cap ({spec})"
    return results[0]


@functools.lru_cache(maxsize=4096)
def _baseline_cached(bench: str, input_gb: float, seed: int,
                     n_workers: int, n_containers: int) -> float:
    spec = JobSpec(job_id="base", bench=bench, input_gb=input_gb)
    # Fault-free baseline is policy-independent (no speculation triggers);
    # run under the YARN substrate defaults.
    return run_single("yarn", spec, None, seed=seed, n_workers=n_workers,
                      n_containers=n_containers).jct


def baseline_jct(bench: str, input_gb: float, *, seed: int = 0,
                 n_workers: int = 20, n_containers: int = 8) -> float:
    return _baseline_cached(bench, float(input_gb), seed, n_workers,
                            n_containers)


def slowdown(policy: str, spec: JobSpec, fault: Optional[FaultFn],
             *, seed: int = 0, n_workers: int = 20,
             n_containers: int = 8, params: Optional[SimParams] = None,
             assess_backend: Optional[str] = None,
             policy_factory=None) -> Tuple[float, JobResult]:
    res = run_single(policy, spec, fault, seed=seed, n_workers=n_workers,
                     n_containers=n_containers, params=params,
                     assess_backend=assess_backend,
                     policy_factory=policy_factory)
    base = baseline_jct(spec.bench, spec.input_gb, seed=seed,
                        n_workers=n_workers, n_containers=n_containers)
    return res.jct / base, res


def run_workload(policy: str, specs: Sequence[JobSpec],
                 fault_script: Optional[Callable[[Simulation], None]] = None,
                 *, seed: int = 0, n_workers: int = 20,
                 n_containers: int = 8,
                 params: Optional[SimParams] = None,
                 assess_backend: Optional[str] = None,
                 policy_factory=None,
                 dispatch_opts: Optional[Dict] = None) -> List[JobResult]:
    sim = Simulation(policy=policy, seed=seed, n_workers=n_workers,
                     n_containers=n_containers, params=params,
                     assess_backend=assess_backend,
                     policy_factory=policy_factory,
                     dispatch_opts=dispatch_opts)
    for spec in specs:
        sim.submit(spec)
    if fault_script is not None:
        fault_script(sim)
    return sim.run()
