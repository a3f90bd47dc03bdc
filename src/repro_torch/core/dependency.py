"""Dependency-aware speculation (the cure for §II.D.1
*dependency-oblivious speculation*).

Tracks the producer→consumer graph (map → MOF → reduce; in the training
runtime: microbatch grads → all-reduce, prefill KV → decode) and decides
when a COMPLETED producer must be re-executed:

- two consecutive fetch failures of one producer's output (§III.B), or
- a positive failure assessment of the node(s) holding the only copy of
  that output (proactive: don't wait for the consumer to trip over it).

Outputs of re-executed completed tasks are kept ALONGSIDE the originals
until job completion (§III.B) — enforcement lives in the substrate; the
policy records which producer ids were re-speculated so the substrate knows
not to discard either copy.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Set

from repro_torch.core.types import (
    ClusterSnapshot,
    FetchFailure,
    SpeculateTask,
    TaskState,
)


@dataclasses.dataclass(frozen=True)
class DependencyConfig:
    # Consecutive fetch failures of one producer before re-execution
    # (paper: "two consecutive intermediate data fetch failures").
    fetch_failure_threshold: int = 2


class DependencyTracker:
    def __init__(self, cfg: DependencyConfig = DependencyConfig()):
        self.cfg = cfg
        self._consecutive: Dict[str, int] = {}
        # Producers re-speculated this job lifetime (both outputs kept).
        self.respeculated: Set[str] = set()

    # ------------------------------------------------------------------
    def note_fetch_ok(self, producer_task_id: str) -> None:
        self._consecutive.pop(producer_task_id, None)

    def on_fetch_failures(
        self, snap: ClusterSnapshot, failures: Sequence[FetchFailure]
    ) -> List[SpeculateTask]:
        """Count consecutive fetch failures per producer; fire at threshold."""
        out: List[SpeculateTask] = []
        for f in failures:
            c = self._consecutive.get(f.producer_task_id, 0) + 1
            self._consecutive[f.producer_task_id] = c
            if c < self.cfg.fetch_failure_threshold:
                continue
            task = snap.tasks.get(f.producer_task_id)
            if task is None:
                continue
            if task.state == TaskState.COMPLETED and not task.output_available:
                pass  # output already known-lost: definitely re-run
            if self._already_rerunning(snap, f.producer_task_id):
                continue
            out.append(SpeculateTask(
                task_id=f.producer_task_id,
                reason="dependency:fetch-failures"))
            self.respeculated.add(f.producer_task_id)
            self._consecutive[f.producer_task_id] = 0
        return out

    # ------------------------------------------------------------------
    def on_node_failed(
        self, snap: ClusterSnapshot, failed_nodes: Iterable[str]
    ) -> List[SpeculateTask]:
        """Proactively re-execute completed producers whose only output
        copies lived on nodes the Eq. 4 monitor just declared dead."""
        failed = set(failed_nodes)
        if not failed:
            return []
        out: List[SpeculateTask] = []
        for t in snap.tasks.values():
            if t.state != TaskState.COMPLETED:
                continue
            if not t.output_nodes:
                continue
            surviving = [n for n in t.output_nodes if n not in failed]
            if surviving:
                continue
            if self._already_rerunning(snap, t.task_id):
                continue
            out.append(SpeculateTask(
                task_id=t.task_id, reason="dependency:producer-node-failed"))
            self.respeculated.add(t.task_id)
        return out

    # ------------------------------------------------------------------
    @staticmethod
    def _already_rerunning(snap: ClusterSnapshot, task_id: str) -> bool:
        t = snap.tasks.get(task_id)
        return t is not None and bool(t.running_attempts())
