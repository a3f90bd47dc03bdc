"""MapReduce job model + the benchmark application profiles of §IV.A.

Each benchmark is a (map rate, MOF ratio, reduce rate) profile: Terasort
moves its whole input through the shuffle, Grep emits almost nothing,
Aggregation is reduce-heavy, etc. Rates are bytes/s of split processing on
the paper's hardware (one 500 GB SATA disk, hex-core Xeons) — chosen so an
unfaulted 1 GB job lands near a minute, matching the paper's small-job
regime (Fig. 1 normalizes against these fault-free baselines, so only the
*ratios* matter for the reproduction claims).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

SPLIT_BYTES = 128 * 2 ** 20  # HDFS block

# Map-task spills per split (progress points the rollback log can resume
# from; Fig. 9 sweeps the failure point across these).
DEFAULT_SPILLS = 5


@dataclasses.dataclass(frozen=True)
class BenchProfile:
    name: str
    map_rate: float       # bytes/s consumed by a map task
    mof_ratio: float      # MOF bytes = split bytes × ratio
    reduce_rate: float    # bytes/s consumed by reduce compute
    output_ratio: float = 0.1  # HDFS output bytes = input bytes × ratio


# The paper's suite: four YARN built-ins + six from HiBench (§IV.A).
# output_ratio feeds the 3-way-replicated HDFS commit (shared 1 GbE).
BENCHMARKS: Dict[str, BenchProfile] = {
    "terasort":      BenchProfile("terasort",      8e6, 1.00, 20e6, 1.00),
    "wordcount":     BenchProfile("wordcount",     6e6, 0.15, 25e6, 0.05),
    "secondarysort": BenchProfile("secondarysort", 8e6, 1.00, 18e6, 1.00),
    "grep":          BenchProfile("grep",         10e6, 0.02, 40e6, 0.01),
    "aggregation":   BenchProfile("aggregation",   7e6, 0.30, 10e6, 0.20),
    "join":          BenchProfile("join",          7e6, 0.90, 15e6, 0.60),
    "kmeans":        BenchProfile("kmeans",        4e6, 0.10, 30e6, 0.05),
    "pagerank":      BenchProfile("pagerank",      6e6, 0.80, 15e6, 0.80),
    "scan":          BenchProfile("scan",         12e6, 0.05, 40e6, 0.05),
    "sort":          BenchProfile("sort",          8e6, 1.00, 20e6, 1.00),
}

# 3-way HDFS write pipeline over the shared 1 GbE: effective commit rate.
HDFS_WRITE_RATE = 5e7


@dataclasses.dataclass(frozen=True)
class JobSpec:
    job_id: str
    bench: str
    input_gb: float
    submit_time: float = 0.0
    n_reduces: Optional[int] = None
    n_spills: int = DEFAULT_SPILLS

    @property
    def profile(self) -> BenchProfile:
        return BENCHMARKS[self.bench]

    @property
    def n_maps(self) -> int:
        return max(1, math.ceil(self.input_gb * 2 ** 30 / SPLIT_BYTES))

    @property
    def reduces(self) -> int:
        if self.n_reduces is not None:
            return self.n_reduces
        # ~2 reducers per GB (Hadoop-era sizing: ~0.5 GB per reducer),
        # capped well under the cluster's slots.
        return max(1, min(32, math.ceil(2 * self.input_gb)))

    def map_work_seconds(self) -> float:
        return SPLIT_BYTES / self.profile.map_rate

    def mof_bytes(self) -> float:
        return SPLIT_BYTES * self.profile.mof_ratio

    def partition_bytes(self) -> float:
        return self.mof_bytes() / self.reduces

    def reduce_work_seconds(self) -> float:
        total_in = self.mof_bytes() * self.n_maps / self.reduces
        compute = total_in / self.profile.reduce_rate
        out_bytes = self.input_gb * 2 ** 30 * self.profile.output_ratio
        commit = out_bytes / self.reduces / HDFS_WRITE_RATE
        return compute + commit


@dataclasses.dataclass
class JobResult:
    job_id: str
    bench: str
    input_gb: float
    submit_time: float
    finish_time: float
    n_spec_attempts: int
    n_attempts: int
    n_fetch_failures: int
    task_durations: List[float]

    @property
    def jct(self) -> float:
        return self.finish_time - self.submit_time
