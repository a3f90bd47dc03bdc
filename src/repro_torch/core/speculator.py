"""The two speculation policies the paper compares.

``YarnLateSpeculator`` — the baseline: YARN's default LATE scheduler
(Zaharia et al., OSDI'08) with its documented myopias kept intact:
 * considers only RUNNING tasks (dependency-oblivious);
 * needs progress-rate *variation* among tasks (scope-limited);
 * serial — at most one speculative launch per assessment tick, with a
   fixed delay between launches;
 * capped speculative count; never resumes from partial progress.

``BinocularSpeculator`` — the paper's contribution: neighborhood glance
(Eq. 1–4) + collective speculation ramp + dependency-aware re-execution of
completed producers + speculative rollback.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.accel.base import AssessmentBackend, get_backend
from repro_torch.core.collective import CollectiveConfig, CollectiveSpeculation
from repro_torch.core.dependency import DependencyConfig, DependencyTracker
from repro_torch.core.glance import GlanceConfig, NeighborhoodGlance
from repro_torch.core.rollback import RollbackRegistry, plan_rollback
from repro_torch.core.types import (
    Action,
    AttemptState,
    ClusterSnapshot,
    KillAttempt,
    MarkNodeFailed,
    SpeculateTask,
    TaskKind,
    TaskState,
    TaskView,
)
from repro_torch.obs.trace import K_BUDGET, K_LATE


class Speculator:
    """Common protocol: one assessment tick → actions."""

    # Optional flight recorder (repro_torch.obs); Simulation._wire_obs / the
    # runtime coordinator set it on the instance.
    obs = None

    def assess(self, snap: ClusterSnapshot) -> List[Action]:  # pragma: no cover
        raise NotImplementedError

    def job_done(self, job_id: str) -> None:
        pass


# ---------------------------------------------------------------------------
# Baseline: YARN default (LATE)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LateConfig:
    # LATE defaults (OSDI'08): SpeculativeCap 10%, SlowTaskThreshold 25th
    # percentile of progress rates, one launch per heartbeat round.
    speculative_cap: float = 0.1
    slow_task_percentile: float = 25.0
    # Fixed delay between speculative launches (the "serial scheme ...
    # with a fixed delay interval" of §II.C).
    launch_delay: float = 15.0
    # Don't speculate a task younger than this (YARN default guard).
    min_runtime: float = 10.0


class YarnLateSpeculator(Speculator):
    def __init__(self, cfg: LateConfig = LateConfig(),
                 assess_backend: "Optional[str | AssessmentBackend]" = None):
        self.cfg = cfg
        self.backend = get_backend(assess_backend)
        self._last_launch: Dict[str, float] = {}
        self._spec_count: Dict[str, int] = {}

    def assess(self, snap: ClusterSnapshot) -> List[Action]:
        arr = getattr(snap, "arrays", None)
        if arr is not None:
            return self._assess_arrays(snap, arr)
        actions: List[Action] = []
        # Kill redundant attempts whose sibling finished (standard YARN).
        # Only for tasks still COMPLETED — a re-activated producer's fresh
        # attempt must not be reaped against its stale completed sibling.
        for t in snap.tasks.values():
            if t.state != TaskState.COMPLETED:
                continue
            if any(a.state == AttemptState.COMPLETED for a in t.attempts):
                for a in t.attempts:
                    if a.state == AttemptState.RUNNING:
                        actions.append(KillAttempt(a.attempt_id,
                                                   "sibling completed"))
        for job_id in snap.job_ids():
            action = self._assess_job(snap, job_id)
            if action is not None:
                actions.append(action)
        return actions

    def _assess_job(self, snap: ClusterSnapshot,
                    job_id: str) -> Optional[SpeculateTask]:
        last = self._last_launch.get(job_id, -1e18)
        if snap.now - last < self.cfg.launch_delay:
            return None  # serial speculation with fixed delay
        tasks = [t for t in snap.tasks.values()
                 if t.job_id == job_id and t.state == TaskState.RUNNING]
        n_total = sum(1 for t in snap.tasks.values() if t.job_id == job_id)
        if self._spec_count.get(job_id, 0) >= max(
                1, int(self.cfg.speculative_cap * n_total)):
            return None
        # Progress rates of all RUNNING attempts (completed tasks are
        # invisible — the dependency myopia, faithfully reproduced).
        rates: List[Tuple[float, float, TaskView]] = []
        for t in tasks:
            if t.has_speculative_running():
                continue
            run = t.running_attempts()
            if not run:
                continue
            a = max(run, key=lambda a: a.progress)
            if snap.now - a.start_time < self.cfg.min_runtime:
                continue
            rho = a.progress_rate(snap.now)
            est_remaining = (1.0 - a.progress) / max(rho, 1e-9)
            rates.append((rho, est_remaining, t))
        if len(rates) < 2:
            # LATE needs variation among tasks to rank stragglers — with
            # zero or one candidate there is nothing to compare against
            # (the scope-limited myopia, faithfully reproduced).
            return None
        rhos = np.asarray([r[0] for r in rates])
        thresh = np.percentile(rhos, self.cfg.slow_task_percentile)
        # STRICTLY below the percentile: with identical rates (a whole job
        # frozen on one node) nothing qualifies — the scope-limited myopia.
        slow = [r for r in rates if r[0] < thresh]
        if not slow:
            return None
        # Speculate the slow task with the LONGEST estimated remaining time.
        rho_v, est_v, victim = max(slow, key=lambda r: r[1])
        self._last_launch[job_id] = snap.now
        self._spec_count[job_id] = self._spec_count.get(job_id, 0) + 1
        if self.obs is not None:
            self.obs.emit(K_LATE, f0=rho_v, f1=float(thresh), f2=est_v,
                          obj=victim.task_id)
        return SpeculateTask(task_id=victim.task_id, reason="late")

    def job_done(self, job_id: str) -> None:
        self._last_launch.pop(job_id, None)
        self._spec_count.pop(job_id, None)

    # --- vectorized path (columnar snapshots, DESIGN.md §11/§13) ------
    def _assess_arrays(self, snap: ClusterSnapshot, arr) -> List[Action]:
        now = snap.now
        actions: List[Action] = [
            KillAttempt(arr.attempt_ids[r], "sibling completed")
            for r in self.backend.reap_rows(arr, now)]
        active = arr.active_jobs()
        if not active:
            return actions
        # Serial-speculation and cap gates are host policy state; jobs
        # failing them need no ranking work (and assessment is pure, so
        # backends may rank every job regardless — results are dropped).
        eligible = np.zeros(len(active), dtype=bool)
        for pos, (jid, jidx) in enumerate(active):
            if now - self._last_launch.get(jid, -1e18) \
                    < self.cfg.launch_delay:
                continue  # serial speculation with fixed delay
            n_total = arr.job_task_count(jidx)
            if self._spec_count.get(jid, 0) >= max(
                    1, int(self.cfg.speculative_cap * n_total)):
                continue
            eligible[pos] = True
        if eligible.any():
            victims = self.backend.late_victims(
                arr, now, active, eligible, self.cfg.min_runtime,
                self.cfg.slow_task_percentile)
            for pos, (jid, _jidx) in enumerate(active):
                if not eligible[pos] or victims[pos] < 0:
                    continue
                self._last_launch[jid] = now
                self._spec_count[jid] = self._spec_count.get(jid, 0) + 1
                if self.obs is not None:
                    # Vectorized path: ρ/threshold stay in the backend;
                    # the record pins victim + time only (§18.2 waiver).
                    self.obs.emit(K_LATE, obj=arr.task_ids[victims[pos]])
                actions.append(SpeculateTask(
                    task_id=arr.task_ids[victims[pos]], reason="late"))
        return actions


# ---------------------------------------------------------------------------
# Cross-job policies under a cluster-wide speculation budget (DESIGN.md §19.3;
# Xu & Lau, "Optimization for Speculative Execution of Multiple Jobs in
# a MapReduce-like Cluster" and "Task-Cloning Algorithms with
# Competitive Performance Bounds" — PAPERS.md). Both meter backup
# launches *across* jobs instead of per-job: the budget bounds the
# number of concurrently RUNNING speculative copies cluster-wide.
# ---------------------------------------------------------------------------
class SpeculationBudget:
    """Cluster-wide speculative-slot meter.

    Accounting contract (DESIGN.md §19.3): at the start of each
    assessment tick ``begin_tick`` re-bases occupancy on the number of
    speculative copies actually RUNNING; ``admit`` then charges this
    tick's launches against the remaining headroom. Copies admitted but
    still queued at the dispatcher (cluster momentarily full) are not
    double-counted — the budget bounds *running* copies plus one tick's
    admissions, not queue depth; the dispatcher's per-task
    ``has_queued`` guard keeps re-proposals of a queued task out.
    """

    def __init__(self, capacity: int):
        self.capacity = max(0, int(capacity))
        self.in_use = 0
        # Lifetime counters (scorecards / benchmarks).
        self.admitted = 0
        self.denied = 0

    def begin_tick(self, running_spec: int) -> None:
        self.in_use = int(running_spec)

    def admit(self, cost: int = 1) -> bool:
        if self.in_use + cost > self.capacity:
            self.denied += 1
            return False
        self.in_use += cost
        self.admitted += 1
        return True

    @property
    def available(self) -> int:
        return max(0, self.capacity - self.in_use)


def _count_running_spec(snap: ClusterSnapshot) -> int:
    """Budget occupancy: RUNNING speculative attempts across every
    active job (columnar when available; the reference walk matches it
    attempt-for-attempt)."""
    arr = getattr(snap, "arrays", None)
    if arr is not None:
        return arr.n_running_spec()
    n = 0
    for t in snap.tasks.values():
        for a in t.attempts:
            if a.state == AttemptState.RUNNING and a.is_speculative:
                n += 1
    return n


@dataclasses.dataclass(frozen=True)
class BudgetConfig:
    # Budget = max(min_budget, fraction × total container slots).
    budget_fraction: float = 0.05
    min_budget: int = 2
    # The inner detector runs un-throttled (no per-job serial delay, no
    # per-job cap) — throttling is the *global* budget's job.
    late: LateConfig = LateConfig(launch_delay=0.0, speculative_cap=1.0)


class BudgetedSpeculator(Speculator):
    """Cross-job speculation with global admission (Xu & Lau).

    An un-throttled LATE detector proposes per-job straggler candidates;
    a cluster-level admission pass ranks them by estimated remaining
    work (largest first — the copies that buy the most completion-time)
    and admits greedily while the cluster-wide budget of speculative
    copies lasts. Kill/reap actions pass through unmetered.
    """

    def __init__(self, total_slots: int = 160,
                 cfg: BudgetConfig = BudgetConfig(),
                 assess_backend: "Optional[str | AssessmentBackend]" = None,
                 budget: Optional[SpeculationBudget] = None):
        self.cfg = cfg
        self.inner = YarnLateSpeculator(cfg.late,
                                        assess_backend=assess_backend)
        self.budget = budget if budget is not None else SpeculationBudget(
            max(cfg.min_budget,
                int(cfg.budget_fraction * total_slots)))

    # The flight recorder threads through the inner detector (its K_LATE
    # records carry the ranking inputs); the wrapper shares it.
    @property
    def obs(self):
        return self.inner.obs

    @obs.setter
    def obs(self, rec) -> None:
        self.inner.obs = rec

    def _est_remaining(self, snap: ClusterSnapshot, task_id: str) -> float:
        t = snap.tasks.get(task_id)
        if t is None:
            return 0.0
        run = [a for a in t.attempts if a.state == AttemptState.RUNNING]
        if not run:
            return 0.0
        a = max(run, key=lambda a: a.progress)
        rho = a.progress_rate(snap.now)
        return (1.0 - a.progress) / max(rho, 1e-9)

    def assess(self, snap: ClusterSnapshot) -> List[Action]:
        actions = self.inner.assess(snap)
        keep: List[Action] = [a for a in actions
                              if not isinstance(a, SpeculateTask)]
        cands = [a for a in actions if isinstance(a, SpeculateTask)]
        self.budget.begin_tick(_count_running_spec(snap))
        admitted = 0
        if cands:
            # Benefit-greedy: longest estimated remaining work first
            # (stable — ties keep per-job submission order).
            ranked = sorted(
                cands,
                key=lambda a: -self._est_remaining(snap, a.task_id))
            for act in ranked:
                if self.budget.admit():
                    admitted += 1
                    keep.append(dataclasses.replace(
                        act, reason="budgeted"))
        if cands and self.obs is not None:
            self.obs.emit(K_BUDGET, a=self.budget.in_use,
                          b=self.budget.capacity, f0=float(len(cands)),
                          f1=float(admitted),
                          f2=float(len(cands) - admitted))
        return keep

    def job_done(self, job_id: str) -> None:
        self.inner.job_done(job_id)


@dataclasses.dataclass(frozen=True)
class CloneConfig:
    # Jobs with at most this many tasks are cloned upfront; bigger jobs
    # fall back to LATE detection (Xu & Lau's small-job regime — the
    # PACMan mix is 85 % such jobs).
    small_job_tasks: int = 12
    budget_fraction: float = 0.15
    min_budget: int = 4
    late: LateConfig = LateConfig()


class CloneSmallJobs(Speculator):
    """Upfront task cloning for small jobs (Xu & Lau).

    Every task of a small job gets one clone as soon as its first
    attempt runs — straggler *avoidance* rather than detection — metered
    by the cluster-wide budget; large jobs keep LATE detection (whose
    candidates for small jobs are dropped: the clone already covers
    them). The sibling-completion reap kills whichever copy loses.
    """

    def __init__(self, total_slots: int = 160,
                 cfg: CloneConfig = CloneConfig(),
                 assess_backend: "Optional[str | AssessmentBackend]" = None,
                 budget: Optional[SpeculationBudget] = None):
        self.cfg = cfg
        self.inner = YarnLateSpeculator(cfg.late,
                                        assess_backend=assess_backend)
        self.budget = budget if budget is not None else SpeculationBudget(
            max(cfg.min_budget,
                int(cfg.budget_fraction * total_slots)))
        self._cloned: Set[str] = set()  # task_ids already offered a clone

    @property
    def obs(self):
        return self.inner.obs

    @obs.setter
    def obs(self, rec) -> None:
        self.inner.obs = rec

    def _small_jobs(self, snap: ClusterSnapshot) -> Set[str]:
        arr = getattr(snap, "arrays", None)
        thr = self.cfg.small_job_tasks
        if arr is not None:
            return {jid for jid, jidx in arr.active_jobs()
                    if arr.job_task_count(jidx) <= thr}
        counts: Dict[str, int] = {}
        for t in snap.tasks.values():
            counts[t.job_id] = counts.get(t.job_id, 0) + 1
        return {jid for jid, c in counts.items() if c <= thr}

    def _clone_candidates(self, snap: ClusterSnapshot,
                          small: Set[str]) -> List[str]:
        """Uncloned small-job tasks with a running attempt and no
        running speculative sibling, in canonical task order."""
        arr = getattr(snap, "arrays", None)
        out: List[str] = []
        if arr is not None:
            rows = arr.running_rows(snap.now)
            if not len(rows):
                return out
            jobmask = np.zeros(len(arr.job_ids), dtype=bool)
            for jid in small:
                jobmask[arr.job_index[jid]] = True
            srows = rows[jobmask[arr.job[rows]]]
            if not len(srows):
                return out
            torder = arr.skey[srows] >> 20
            starts, inv = arr.task_segments(torder)
            has_spec = np.bincount(inv, weights=arr.spec[srows],
                                   minlength=len(starts)) > 0
            for pos, r in enumerate(srows[starts]):
                if has_spec[pos]:
                    continue
                tid = arr.task_ids[r]
                if tid not in self._cloned:
                    out.append(tid)
            return out
        for t in snap.tasks.values():
            if t.job_id not in small or t.state != TaskState.RUNNING:
                continue
            if t.task_id in self._cloned or t.has_speculative_running():
                continue
            if any(a.state == AttemptState.RUNNING for a in t.attempts):
                out.append(t.task_id)
        return out

    def assess(self, snap: ClusterSnapshot) -> List[Action]:
        actions = self.inner.assess(snap)
        small = self._small_jobs(snap)
        keep: List[Action] = []
        for a in actions:
            if isinstance(a, SpeculateTask):
                tv = snap.tasks.get(a.task_id)
                if tv is not None and tv.job_id in small:
                    continue  # the upfront clone covers this task
            keep.append(a)
        self.budget.begin_tick(_count_running_spec(snap))
        cands = self._clone_candidates(snap, small)
        admitted = 0
        for task_id in cands:
            if not self.budget.admit():
                break
            self._cloned.add(task_id)
            admitted += 1
            keep.append(SpeculateTask(task_id=task_id, reason="clone"))
        if cands and self.obs is not None:
            self.obs.emit(K_BUDGET, a=self.budget.in_use,
                          b=self.budget.capacity, f0=float(len(cands)),
                          f1=float(admitted),
                          f2=float(len(cands) - admitted))
        return keep

    def job_done(self, job_id: str) -> None:
        self.inner.job_done(job_id)
        prefix = job_id + "_"
        self._cloned = {t for t in self._cloned
                        if not t.startswith(prefix)}


# ---------------------------------------------------------------------------
# Binocular speculation
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class _StragglerTask:
    """The slice of the TaskView protocol the collective planner reads —
    lets the columnar path hand it stragglers without building views."""

    task_id: str
    job_id: str
    _has_spec: bool = False

    def has_speculative_running(self) -> bool:
        return self._has_spec


@dataclasses.dataclass(frozen=True)
class BinoConfig:
    glance: GlanceConfig = dataclasses.field(default_factory=GlanceConfig)
    collective: CollectiveConfig = dataclasses.field(
        default_factory=CollectiveConfig)
    dependency: DependencyConfig = dataclasses.field(
        default_factory=DependencyConfig)
    rollback_enabled: bool = True


class BinocularSpeculator(Speculator):
    def __init__(self, node_ids: Sequence[str],
                 cfg: BinoConfig = BinoConfig(),
                 topology: Optional[Dict[str, Sequence[str]]] = None,
                 assess_backend: "Optional[str | AssessmentBackend]" = None):
        self.cfg = cfg
        # One backend instance serves glance + collective (it memoizes the
        # per-tick extraction / device upload across both).
        self.backend = get_backend(
            assess_backend if assess_backend is not None
            else cfg.glance.assess_backend)
        self.glance = NeighborhoodGlance(node_ids, cfg.glance, topology,
                                         backend=self.backend)
        self.collective = CollectiveSpeculation(cfg.collective,
                                                backend=self.backend)
        self.dependency = DependencyTracker(cfg.dependency)
        self.rollback = RollbackRegistry()
        # Nodes currently assessed unhealthy (slow or failed).
        self._unhealthy: Set[str] = set()

    # ------------------------------------------------------------------
    def assess(self, snap: ClusterSnapshot) -> List[Action]:
        actions: List[Action] = []

        # 1. Neighborhood glance: spatial + temporal + failure assessments.
        verdict = self.glance.assess(snap)
        failed = set(verdict.failed_nodes)
        for nid in failed:
            actions.append(MarkNodeFailed(nid, reason="glance:eq4"))
            self.rollback.drop_node(nid)
        slow_by_node: Dict[str, str] = {}
        for _job, node, reason in verdict.slow_nodes:
            slow_by_node.setdefault(node, reason)
        self._unhealthy = failed | set(slow_by_node)

        # 2. Dependency awareness: completed producers on dead nodes, and
        #    fetch-failure streaks, trigger producer re-execution.
        dep_actions = self.dependency.on_node_failed(snap, failed)
        dep_actions += self.dependency.on_fetch_failures(
            snap, snap.fetch_failures)

        # 3. Straggler set: running tasks on slow/failed nodes.
        arr = getattr(snap, "arrays", None)
        if arr is not None:
            stragglers = self._stragglers_arrays(
                snap, arr, failed, slow_by_node)
        else:
            stragglers = self._stragglers_reference(
                snap, failed, slow_by_node)

        # 4. Collective ramp over the straggler wave, neighborhood-first.
        nh = {n: self.glance.neighbors_of(n) for n in
              {v for _, v, _ in stragglers if v is not None}}
        launches = self.collective.plan(snap, stragglers, nh)

        # Dependency re-executions bypass the ramp: they gate job progress
        # (a reducer is already blocked on the lost output).
        launches = list(dep_actions) + launches

        # 5. Rollback: race a resume-from-log attempt where the log's node
        #    is healthy.
        if self.cfg.rollback_enabled:
            launches = plan_rollback(snap, self.rollback, launches,
                                     self._unhealthy)
        actions.extend(launches)

        # 6. Reap siblings of completed attempts.
        actions.extend(self.collective.reap_completed(snap))
        return actions

    # ------------------------------------------------------------------
    # Straggler extraction: first running attempt of a RUNNING task that
    # sits on a slow/failed node decides the task's victim node + reason.
    # ------------------------------------------------------------------
    def _stragglers_reference(
        self, snap: ClusterSnapshot, failed: Set[str],
        slow_by_node: Dict[str, str],
    ) -> List[Tuple[TaskView, Optional[str], str]]:
        stragglers: List[Tuple[TaskView, Optional[str], str]] = []
        seen: Set[str] = set()
        for t in snap.tasks.values():
            if t.state != TaskState.RUNNING:
                continue
            for a in t.running_attempts():
                if t.task_id in seen:
                    break
                if a.node_id in failed:
                    stragglers.append((t, a.node_id, "glance:failure"))
                    seen.add(t.task_id)
                elif a.node_id in slow_by_node:
                    stragglers.append(
                        (t, a.node_id,
                         "glance:" + slow_by_node[a.node_id]))
                    seen.add(t.task_id)
        return stragglers

    def _stragglers_arrays(
        self, snap: ClusterSnapshot, arr, failed: Set[str],
        slow_by_node: Dict[str, str],
    ) -> List[Tuple["_StragglerTask", Optional[str], str]]:
        """Columnar straggler extraction. On a healthy tick (no slow or
        failed nodes — the common case) this is a no-op; otherwise the
        first-bad-attempt-per-task pick and the speculative-sibling check
        are segmented reductions, and the collective planner receives
        lightweight task shims instead of materialized TaskViews."""
        from repro_torch.core.arrays import A_RUNNING, T_RUNNING
        bad = failed | set(slow_by_node)
        if not bad:
            return []
        nodemask = np.zeros(len(arr.node_ids), dtype=bool)
        for nid in bad:
            nodemask[arr.node_index[nid]] = True
        rows = arr.running_rows(snap.now)  # all running attempts, canonical
        if not len(rows):
            return []
        on_bad = nodemask[arr.node[rows]]
        brows = rows[on_bad]
        if not len(brows):
            return []
        # Victim attempt = first bad-node running attempt per task in
        # canonical order — exactly the reference scan's pick. Rows are
        # sorted by task, so segment starts are the per-task firsts,
        # already in task order.
        torder = arr.skey[rows] >> 20
        btorder = torder[on_bad]
        bstarts, _binv = arr.task_segments(btorder)
        vrows = brows[bstarts]
        # has_speculative_running per straggler task, over ALL of the
        # task's running attempts (not just the bad-node ones).
        starts, inv = arr.task_segments(torder)
        has_spec = np.bincount(inv, weights=arr.spec[rows],
                               minlength=len(starts)) > 0
        vspec = has_spec[np.searchsorted(torder[starts], btorder[bstarts])]
        stragglers: List[Tuple[_StragglerTask, Optional[str], str]] = []
        for r, hs in zip(vrows, vspec):
            nid = arr.node_ids[arr.node[r]]
            if nid in failed:
                reason = "glance:failure"
            else:
                reason = "glance:" + slow_by_node[nid]
            stragglers.append((_StragglerTask(
                arr.task_ids[r], arr.job_ids[arr.job[r]], bool(hs)),
                nid, reason))
        return stragglers

    # ------------------------------------------------------------------
    # Substrate hooks
    # ------------------------------------------------------------------
    def record_progress_log(self, log) -> None:
        self.rollback.record(log)

    def note_fetch_ok(self, producer_task_id: str) -> None:
        self.dependency.note_fetch_ok(producer_task_id)

    def job_done(self, job_id: str) -> None:
        self.collective.job_done(job_id)

    @property
    def unhealthy_nodes(self) -> Set[str]:
        return set(self._unhealthy)
