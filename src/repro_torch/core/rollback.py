"""Speculative rollback (§III.C): lightweight progress logs + race recovery.

The substrate registers per-task progress logs — the analogue of the paper's
``(spill path, input-split offset)``:

- simulator: (node, spills_completed, split_offset);
- training runtime: (host, step, microbatch index, data-shard offset, RNG).

When a task is reported slow/failed and its *original node is still healthy*,
the policy launches TWO racing attempts (§III.C): a rollback attempt on the
original node resuming from the logged offset, and an ordinary attempt on a
fast node. If the original node is itself the slow/failed party, only the
ordinary attempt is placed ("an additional speculation is not allowed").
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.types import ClusterSnapshot, SpeculateTask


@dataclasses.dataclass
class ProgressLog:
    """What survives on the original node for resuming a task."""

    task_id: str
    node_id: str
    # Fraction of the task's work already durable on that node (spills
    # written / microbatches accumulated). Resume skips this fraction.
    offset: float
    # Substrate-opaque handle (spill path / data-pipeline state blob).
    handle: object = None


class RollbackRegistry:
    """Coordinator-side registry of progress logs, fed by heartbeats."""

    def __init__(self):
        self._logs: Dict[str, ProgressLog] = {}

    def record(self, log: ProgressLog) -> None:
        prev = self._logs.get(log.task_id)
        # Keep the most-advanced log per task (later spill wins).
        if prev is None or log.offset >= prev.offset:
            self._logs[log.task_id] = log

    def get(self, task_id: str) -> Optional[ProgressLog]:
        return self._logs.get(task_id)

    def drop_node(self, node_id: str) -> None:
        """A dead node's local logs are gone (they are NOT replicated —
        §III.C explicitly rejects heavyweight remote checkpointing)."""
        self._logs = {t: l for t, l in self._logs.items()
                      if l.node_id != node_id}

    def drop_task(self, task_id: str) -> None:
        self._logs.pop(task_id, None)


def plan_rollback(
    snap: ClusterSnapshot,
    registry: RollbackRegistry,
    launches: Sequence[SpeculateTask],
    unhealthy_nodes: Set[str],
) -> List[SpeculateTask]:
    """Augment a wave of speculative launches with rollback attempts.

    For each planned ordinary launch whose task has a progress log on a
    healthy node, prepend a rollback attempt on that node. The ordinary
    attempt still races it from another node.
    """
    out: List[SpeculateTask] = []
    for action in launches:
        log = registry.get(action.task_id)
        if (log is not None
                and log.node_id not in unhealthy_nodes
                and log.node_id in snap.nodes
                and not snap.nodes[log.node_id].marked_failed
                and log.offset > 0.0):
            out.append(SpeculateTask(
                task_id=action.task_id,
                placement_hint=(log.node_id,),
                rollback=True,
                rollback_node=log.node_id,
                reason=action.reason + "+rollback"))
            # The racing ordinary attempt should avoid the original node.
            hint = tuple(n for n in action.placement_hint
                         if n != log.node_id)
            action = dataclasses.replace(action, placement_hint=hint)
        out.append(action)
    return out
