"""Shared control-plane types for the binocular-speculation policy engine.

The policy engine (``repro_torch.core``) is deliberately decoupled from any
execution substrate: it consumes immutable :class:`ClusterSnapshot` views and
emits :class:`Action` values. Two substrates drive it:

- ``repro_torch.sim`` — the deterministic discrete-event MapReduce simulator that
  reproduces the paper's own experiments (Figs. 1–9), and
- ``repro.runtime`` — the live JAX training runtime, where "map tasks" are
  per-host microbatch gradient production and "reduce tasks" are the
  all-reduce + optimizer phase (see DESIGN.md §2 for the full mapping).

Keeping one policy implementation behind one snapshot protocol is what makes
the reproduction *faithful*: the math of Eq. 1–4 and the collective ramp are
exercised identically by the paper's benchmarks and by the training runtime.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Mapping, Optional, Sequence, Tuple


class TaskKind(str, enum.Enum):
    MAP = "map"          # short-lived producer (microbatch grad / prefill)
    REDUCE = "reduce"    # long-lived dependent consumer (optimizer / decode)


class TaskState(str, enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    COMPLETED = "completed"
    FAILED = "failed"


class AttemptState(str, enum.Enum):
    RUNNING = "running"
    COMPLETED = "completed"
    FAILED = "failed"
    KILLED = "killed"


@dataclasses.dataclass
class AttemptView:
    """One execution attempt of a task (original or speculative)."""

    attempt_id: str
    task_id: str
    node_id: str
    state: AttemptState
    start_time: float
    # ProgressScore ζ(t) ∈ [0, 1]  (YARN's per-task progress metric).
    progress: float = 0.0
    is_speculative: bool = False
    is_rollback: bool = False

    def progress_rate(self, now: float) -> float:
        """ρ(t) = ζ(t) / τ_t — the LATE/Eq.1 task progress rate."""
        dt = max(now - self.start_time, 1e-9)
        return self.progress / dt


@dataclasses.dataclass
class TaskView:
    task_id: str
    job_id: str
    kind: TaskKind
    state: TaskState
    attempts: List[AttemptView] = dataclasses.field(default_factory=list)
    # Producer dependencies: for a reduce task, the map task ids whose
    # intermediate output (MOF / gradient shard / KV shard) it consumes.
    deps: Tuple[str, ...] = ()
    # Node(s) currently holding this task's committed output (MOF location).
    output_nodes: Tuple[str, ...] = ()
    # True once at least one complete output copy is fetchable.
    output_available: bool = False

    def running_attempts(self) -> List[AttemptView]:
        return [a for a in self.attempts if a.state == AttemptState.RUNNING]

    def has_speculative_running(self) -> bool:
        return any(a.is_speculative for a in self.running_attempts())


@dataclasses.dataclass
class NodeView:
    node_id: str
    # Time of last heartbeat received by the coordinator.
    last_heartbeat: float
    # Containers: total slots and currently-free slots on this node.
    total_containers: int = 1
    free_containers: int = 0
    # Attempts currently placed on this node.
    attempt_ids: Tuple[str, ...] = ()
    # Externally-confirmed dead (e.g. the substrate decommissioned it).
    marked_failed: bool = False


@dataclasses.dataclass
class FetchFailure:
    """A consumer attempt failed to fetch a producer's intermediate output."""

    time: float
    consumer_task_id: str
    producer_task_id: str


@dataclasses.dataclass
class ClusterSnapshot:
    """Immutable coordinator view handed to a speculator on each tick.

    When the substrate maintains a columnar mirror of the same state
    (``repro_torch.core.arrays.ArraySnapshot``), it is attached as ``arrays`` and
    the policies take their vectorized assessment paths; ``nodes``/``tasks``
    may then be lazy mappings that materialize views only on access, so the
    per-object protocol keeps working unchanged (DESIGN.md §11.2). With
    ``arrays is None`` (the live runtime coordinator, unit tests) every
    policy uses the per-object reference path.
    """

    now: float
    nodes: Mapping[str, NodeView]
    tasks: Mapping[str, TaskView]
    # Fetch failures since the previous snapshot (cleared by the substrate).
    fetch_failures: Sequence[FetchFailure] = ()
    # Optional columnar mirror (repro_torch.core.arrays.ArraySnapshot).
    arrays: Optional[object] = None

    def job_tasks(self, job_id: str) -> List[TaskView]:
        return [t for t in self.tasks.values() if t.job_id == job_id]

    def job_ids(self) -> List[str]:
        seen: Dict[str, None] = {}
        for t in self.tasks.values():
            seen.setdefault(t.job_id)
        return list(seen)

    def attempts_on(self, node_id: str) -> List[AttemptView]:
        out = []
        for t in self.tasks.values():
            for a in t.attempts:
                if a.node_id == node_id and a.state == AttemptState.RUNNING:
                    out.append(a)
        return out


# ---------------------------------------------------------------------------
# Actions emitted by a speculator. The substrate executes them.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SpeculateTask:
    """Launch a (speculative) attempt of ``task_id``.

    ``placement_hint`` lists node ids in preference order (neighborhood
    first, per §III.B); the substrate picks the first with a free container.
    ``rollback`` requests resume-from-progress-log on ``rollback_node``
    (§III.C); the substrate falls back to a fresh attempt if the log is gone.
    ``reason`` tags which assessment fired (spatial/temporal/failure/
    dependency/late) — benchmarks aggregate on it.
    """

    task_id: str
    placement_hint: Tuple[str, ...] = ()
    rollback: bool = False
    rollback_node: Optional[str] = None
    reason: str = ""


@dataclasses.dataclass
class KillAttempt:
    attempt_id: str
    reason: str = ""


@dataclasses.dataclass
class MarkNodeFailed:
    """Coordinator verdict from the Eq. 4 failure assessment: treat the node
    as dead *now* instead of waiting for the substrate's long expiry."""

    node_id: str
    reason: str = ""


Action = object  # Union[SpeculateTask, KillAttempt, MarkNodeFailed]
