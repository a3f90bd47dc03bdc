"""Collective speculation (§III.B): replace YARN's serial
one-speculation-per-heartbeat scheme with a ramped, neighborhood-first
collective launch.

Per straggler wave:
1. every straggler task gets an attempt in the victim node's *neighborhood*
   if containers are free there (cheap state transfer);
2. beyond the neighborhood, launches ramp geometrically —
   ``COLL_INIT_NUM × COLL_MULTIPLY^i`` in round ``i`` — but only while
   speculation is *winning* (some speculative attempt outpaces its
   original), which bounds resource burn when the cluster is merely busy;
3. when any attempt of a task completes, the others are killed (the
   substrate also enforces this; the policy emits the kill for promptness).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.accel.base import AssessmentBackend, get_backend
from repro_torch.core.types import (
    AttemptState,
    ClusterSnapshot,
    KillAttempt,
    SpeculateTask,
    TaskState,
    TaskView,
)
from repro_torch.obs.trace import K_RAMP


@dataclasses.dataclass(frozen=True)
class CollectiveConfig:
    coll_init_num: int = 1
    coll_multiply: int = 2
    # Seconds between ramp rounds ("a very small duration for periodic
    # progress checking" — §III.B).
    check_period: float = 2.0
    # A speculative attempt "wins" when its rate exceeds the original's by
    # this factor.
    win_factor: float = 1.0


class CollectiveSpeculation:
    """Tracks the ramp state and turns straggler sets into launch actions."""

    def __init__(self, cfg: CollectiveConfig = CollectiveConfig(),
                 backend: "Optional[str | AssessmentBackend]" = None):
        self.cfg = cfg
        self.backend = get_backend(backend)
        # Optional flight recorder (repro_torch.obs): one K_RAMP record per
        # ramp round that actually launches.
        self.obs = None
        # Per job: ramp round and last ramp time.
        self._round: Dict[str, int] = {}
        self._last_check: Dict[str, float] = {}
        # Tasks already given a live speculative attempt this wave.
        self._speculated: Set[str] = set()

    # ------------------------------------------------------------------
    def _speculation_winning(self, snap: ClusterSnapshot, job_id: str) -> bool:
        """True if any live speculative attempt outpaces its original —
        the gate for continuing the geometric ramp."""
        arr = getattr(snap, "arrays", None)
        if arr is not None:
            jidx = arr.job_index.get(job_id)
            if jidx is None:
                return False
            return self.backend.winning(arr, snap.now, jidx,
                                        self.cfg.win_factor)
        for t in snap.tasks.values():
            if t.job_id != job_id:
                continue
            orig = [a for a in t.running_attempts() if not a.is_speculative]
            spec = [a for a in t.running_attempts() if a.is_speculative]
            if not spec:
                continue
            if not orig:
                return True  # original is gone; speculation is the job now
            o = max(a.progress_rate(snap.now) for a in orig)
            s = max(a.progress_rate(snap.now) for a in spec)
            if s > o * self.cfg.win_factor:
                return True
        return False

    def _free_in(self, snap: ClusterSnapshot, nodes: Sequence[str]) -> int:
        return sum(snap.nodes[n].free_containers for n in nodes
                   if n in snap.nodes and not snap.nodes[n].marked_failed)

    # ------------------------------------------------------------------
    def plan(
        self,
        snap: ClusterSnapshot,
        stragglers: Sequence[Tuple[TaskView, Optional[str], str]],
        neighborhood: Dict[str, List[str]],
    ) -> List[SpeculateTask]:
        """stragglers: (task, victim_node or None, reason) triples; a task
        appears at most once. ``neighborhood`` maps node → preferred
        placement order (victim's neighbors first)."""
        actions: List[SpeculateTask] = []
        # Drop tasks that already have a live speculative attempt, and let
        # re-waves re-speculate tasks whose speculative attempt died.
        todo: List[Tuple[TaskView, Optional[str], str]] = []
        for task, victim, reason in stragglers:
            if task.has_speculative_running():
                self._speculated.add(task.task_id)
                continue
            todo.append((task, victim, reason))
            self._speculated.discard(task.task_id)
        if not todo:
            return actions

        by_job: Dict[str, List[Tuple[TaskView, Optional[str], str]]] = {}
        for item in todo:
            by_job.setdefault(item[0].job_id, []).append(item)

        for job_id, items in by_job.items():
            rnd = self._round.get(job_id, 0)
            last = self._last_check.get(job_id)
            if last is not None and (snap.now - last) < self.cfg.check_period:
                continue
            self._last_check[job_id] = snap.now

            # Wave 1: fill the neighborhoods' free containers.
            nh_nodes: List[str] = []
            for _, victim, _ in items:
                if victim is not None:
                    nh_nodes.extend(neighborhood.get(victim, []))
            nh_budget = self._free_in(snap, dict.fromkeys(nh_nodes))

            # Beyond the neighborhood: geometric ramp, gated on winning.
            if rnd == 0:
                beyond_budget = self.cfg.coll_init_num
            elif self._speculation_winning(snap, job_id):
                beyond_budget = self.cfg.coll_init_num * (
                    self.cfg.coll_multiply ** rnd)
            else:
                beyond_budget = 0  # hold the ramp; keep what we have
            budget = nh_budget + beyond_budget
            if budget <= 0:
                continue

            launched = 0
            for task, victim, reason in items:
                if launched >= budget:
                    break
                hint = tuple(neighborhood.get(victim, [])) if victim else ()
                actions.append(SpeculateTask(
                    task_id=task.task_id, placement_hint=hint,
                    reason=reason))
                self._speculated.add(task.task_id)
                launched += 1
            if launched > 0:
                self._round[job_id] = rnd + 1
                if self.obs is not None:
                    self.obs.emit(K_RAMP, a=rnd, b=launched,
                                  f0=float(nh_budget),
                                  f1=float(beyond_budget), obj=job_id)

        return actions

    # ------------------------------------------------------------------
    def reap_completed(self, snap: ClusterSnapshot) -> List[KillAttempt]:
        """If either copy of a task finished, terminate the other (§III.B)."""
        arr = getattr(snap, "arrays", None)
        if arr is not None:
            return [KillAttempt(attempt_id=arr.attempt_ids[r],
                                reason="sibling attempt completed")
                    for r in self.backend.reap_rows(arr, snap.now)]
        kills: List[KillAttempt] = []
        for t in snap.tasks.values():
            # Task must be COMPLETED *now*: a re-activated producer (output
            # lost, task running again) has stale completed attempts whose
            # siblings are the recovery — do not reap those.
            if t.state != TaskState.COMPLETED:
                continue
            done = any(a.state == AttemptState.COMPLETED for a in t.attempts)
            if not done:
                continue
            for a in t.attempts:
                if a.state == AttemptState.RUNNING:
                    kills.append(KillAttempt(
                        attempt_id=a.attempt_id,
                        reason="sibling attempt completed"))
        return kills

    def job_done(self, job_id: str) -> None:
        self._round.pop(job_id, None)
        self._last_check.pop(job_id, None)
