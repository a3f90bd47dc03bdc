"""Deterministic discrete-event MapReduce simulator — the faithful-semantics
substrate for reproducing the paper's experiments (Figs. 1–9). The policy
engine under test is ``repro_torch.core``; the simulator supplies YARN 2.7.1
execution semantics (NM expiry, shuffle fetch-failure cycles, slowstart,
container packing) and seeded fault injection. ``runner`` and
``workload`` are not ported yet (ROADMAP).
"""
from repro_torch.sim.cluster import Cluster, SimNode
from repro_torch.sim.dispatch import Dispatcher, LaunchRequest
from repro_torch.sim.engine import Engine
from repro_torch.sim.job import BENCHMARKS, BenchProfile, JobResult, JobSpec
from repro_torch.sim.mapreduce import BINO_PARAMS, SimParams, Simulation
from repro_torch.sim.shuffle import (
    BatchShuffle,
    EventShuffle,
    MofRegistry,
    RescanShuffle,
)
from repro_torch.sim import dispatch, faults, shuffle

__all__ = [
    "BENCHMARKS", "BINO_PARAMS", "BatchShuffle", "BenchProfile", "Cluster",
    "Dispatcher", "Engine", "EventShuffle", "JobResult", "JobSpec",
    "LaunchRequest", "MofRegistry", "RescanShuffle", "SimNode", "SimParams",
    "Simulation", "dispatch", "faults", "shuffle",
]
