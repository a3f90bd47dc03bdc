"""Container scheduling: the multi-tenant AM/RM dispatch plane
(DESIGN.md §12.4, §19).

Owns the pending-launch queues and the container-placement pass that was
inlined in ``Simulation``. The dispatcher decides *where and when* an
attempt runs (placement preference, exclusion of sibling hosts and
marked-failed nodes, max-running-attempts cap); the simulation retains
attempt *construction* (``Simulation._start_attempt``) because that is
lifecycle state (arrays write-through, milestones, shuffle attach).

The plane is multi-tenant (tenant = job):

* **Per-tenant queues + index.** Pending launches live in per-job
  deques, with a ``task_id → queued-count`` index, so ``has_queued`` and
  the watchdog's queued-set are O(1) instead of O(pending) scans.
* **Deficit round-robin fair-share.** With more than one tenant holding
  demand, free containers are granted by DRR over the tenant rotation
  (arrival order): each cycle a tenant earns its quantum (weight,
  default 1) of container credit and serves until a grant spends it or
  its head request blocks. A single tenant — or ``fair=False`` — runs
  the legacy strict-FIFO pass, byte-identical to the pre-§19 plane (the
  single-job equivalence gate; with ``fair=False`` all tenants share one
  arrival-ordered queue, i.e. the exact legacy global FIFO).
* **Bulk placement.** With the columnar mirror on and a deep enough
  batch, the placement pass runs against a pass-local copy of the
  ``node_free`` column with a low-water pointer instead of per-request
  heap queries — same decisions (the dispatch column of the fuzz matrix
  pins bulk ≡ scalar byte-identical), one vectorized setup per drain in
  the spirit of the shuffle's bulk staging.
* **Capped requests are retained** (a bugfix). The old pass
  silently dropped a ``LaunchRequest`` whose task sat at
  ``max_running_attempts``, losing rollback/placement metadata; the
  request now stays queued until the cap clears or the task finishes.
* **``enqueue`` is a no-op for finished jobs** (a bugfix). The
  completed-producer re-execution branch used to mutate task state and
  decrement ``n_maps_done`` before checking whether the request could
  ever place; a request against a done job is now dropped before any
  mutation (the ``n_maps_done >= 0`` invariant in tests/conftest.py).
"""
from __future__ import annotations

import time
from collections import OrderedDict, deque
from typing import TYPE_CHECKING, Deque, Dict, List, Optional, Tuple

import dataclasses

from repro_torch.core.types import TaskKind, TaskState
from repro_torch.obs.trace import K_DISPATCH

if TYPE_CHECKING:  # pragma: no cover - import cycle guard, typing only
    from repro_torch.sim.mapreduce import SimTask, Simulation


@dataclasses.dataclass
class LaunchRequest:
    task: "SimTask"
    placement: Tuple[str, ...] = ()
    speculative: bool = False
    rollback: bool = False
    rollback_node: Optional[str] = None
    reason: str = ""


# Placement-pass outcomes (shared by the scalar and bulk passes).
_GRANT, _KEEP, _DROP = 0, 1, 2

# Batch depth at which the bulk pass pays for its per-pass setup (one
# node_free copy); below it the scalar heap query wins.
_BULK_MIN = 16


class Dispatcher:
    """Per-tenant pending queues + the placement pass over free
    containers.

    ``fair``      — DRR fair-share across tenants (default). ``False``
                    collapses every tenant into one arrival-ordered
                    queue: the legacy global-FIFO pass.
    ``bulk``      — force the bulk placement pass on/off; ``None``
                    (default) auto-selects it when the columnar mirror
                    exists and the batch is at least ``bulk_min`` deep.
    ``weights``   — optional tenant → DRR quantum map (containers of
                    credit per rotation cycle; default 1.0 each).
    ``profile``   — accumulate wall-clock in ``decision_wall`` around
                    each placement pass (benchmarks/perf_dispatch.py).
    """

    def __init__(self, sim: "Simulation", *, fair: bool = True,
                 bulk: Optional[bool] = None, bulk_min: int = _BULK_MIN,
                 weights: Optional[Dict[str, float]] = None,
                 profile: bool = False):
        self.sim = sim
        self.fair = fair
        self.bulk = bulk
        self.bulk_min = bulk_min
        self.weights = weights or {}
        for jid, w in self.weights.items():
            if not w > 0:
                raise ValueError(f"tenant weight must be > 0: {jid}={w}")
        self.profile = profile
        # tenant (job_id) → FIFO of its pending launches, in arrival
        # order of first demand; "" is the shared legacy queue
        # (fair=False).
        self._queues: "OrderedDict[str, Deque[LaunchRequest]]" = \
            OrderedDict()
        # task_id → number of queued requests (the O(1) has_queued /
        # watchdog index).
        self._queued: Dict[str, int] = {}
        self._total = 0
        # Plane accounting (read by benchmarks and the metrics plane).
        self.n_decisions = 0   # placement decisions attempted
        self.n_grants = 0      # containers granted
        self.n_bulk_passes = 0
        self.n_scalar_passes = 0
        self.n_skipped_passes = 0   # zero-free early-outs
        self.decision_wall = 0.0

    # ------------------------------------------------------------------
    # Queue maintenance
    # ------------------------------------------------------------------
    def _tenant(self, req: LaunchRequest) -> str:
        return req.task.job.spec.job_id if self.fair else ""

    def enqueue(self, req: LaunchRequest) -> None:
        task = req.task
        if task.job.done:
            # The placement pass would drop this request unlaunched
            # anyway; dropping it *before* the completed-producer branch
            # keeps a finished job's n_maps_done / task states frozen
            # (bugfix — MOF loss racing job completion).
            return
        if task.state == TaskState.COMPLETED and not req.speculative:
            # re-execution of a completed producer
            if task.kind == TaskKind.MAP:
                task.job.n_maps_done -= 1
            task.state = TaskState.RUNNING
            task.output_available = bool(task.output_nodes)
            self.sim._arr_task_state(task)
        jid = self._tenant(req)
        q = self._queues.get(jid)
        if q is None:
            q = self._queues[jid] = deque()
        q.append(req)
        tid = task.task_id
        self._queued[tid] = self._queued.get(tid, 0) + 1
        self._total += 1

    def _unindex(self, task: "SimTask") -> None:
        tid = task.task_id
        c = self._queued.get(tid, 0) - 1
        if c > 0:
            self._queued[tid] = c
        else:
            self._queued.pop(tid, None)
        self._total -= 1

    def task_done(self, task: "SimTask") -> None:
        """Eager purge on task completion: queued launches for the task
        drop immediately, so ``has_queued`` flips false the instant the
        task completes (not at the next placement pass) and an unvisited
        request can never be a stale drop — what lets the placement pass
        stop at pool exhaustion instead of rescanning the whole backlog.
        O(1) when the task had nothing queued (the common case)."""
        if not self._queued.pop(task.task_id, 0):
            return
        jid = task.job.spec.job_id if self.fair else ""
        q = self._queues.get(jid)
        if q:
            kept = deque(r for r in q if r.task is not task)
            self._total -= len(q) - len(kept)
            self._queues[jid] = kept

    def job_done(self, job_id: str) -> None:
        """Tenant teardown on job completion: the whole queue drops."""
        if self.fair:
            q = self._queues.pop(job_id, None)
            if not q:
                return
        else:
            shared = self._queues.get("")
            if not shared:
                return
            q = [r for r in shared
                 if r.task.job.spec.job_id == job_id]
            if not q:
                return
            self._queues[""] = deque(
                r for r in shared if r.task.job.spec.job_id != job_id)
        for r in q:
            self._unindex(r.task)

    @property
    def pending(self) -> List[LaunchRequest]:
        """Flat view of every queued launch (tenant rotation order, FIFO
        within a tenant) — compatibility/introspection only; the plane
        itself never walks it."""
        return [r for q in self._queues.values() for r in q]

    def has_queued(self, task: "SimTask") -> bool:
        return self._queued.get(task.task_id, 0) > 0

    # ------------------------------------------------------------------
    # Placement pass
    # ------------------------------------------------------------------
    def dispatch(self) -> None:
        if not self._total:
            return
        t0 = time.perf_counter() if self.profile else 0.0
        arr = self.sim.arrays
        # Grant budget: a pass can grant at most the cluster's free
        # slots, and with the eager task_done/job_done purge every
        # queued request is live, so once the pool is spent the rest of
        # the backlog could only KEEP — stopping there is
        # outcome-identical to the full rescan. The sum may overcount
        # by marked-node slots (excluded from placement); that only
        # delays the stop, never changes a decision. Without the
        # columnar mirror there is no O(nodes) free sum, so the
        # reference pass visits everything (budget=None).
        budget: Optional[int] = None
        if arr is not None:
            budget = int(arr.node_free.sum())
            if not budget:
                # Cluster exactly full: nothing can place; skip the
                # pass entirely. O(nodes) early-out instead of the
                # O(pending) full rescan that was the bulk of the
                # 10 000-node dispatch wall.
                self.n_skipped_passes += 1
                if self.profile:
                    self.decision_wall += time.perf_counter() - t0
                return
        if self.bulk is None:
            use_bulk = arr is not None and self._total >= self.bulk_min
        else:
            use_bulk = bool(self.bulk) and arr is not None
        if use_bulk:
            self.n_bulk_passes += 1
            self._run_pass(self._make_bulk_try(), budget)
        else:
            self.n_scalar_passes += 1
            self._run_pass(self._try_scalar, budget)
        if self.profile:
            self.decision_wall += time.perf_counter() - t0

    def _run_pass(self, try_place, budget: Optional[int]) -> None:
        """One placement pass: every queued request is visited at most
        once, and at most ``budget`` grants are issued (the pass stops
        once the free pool is provably spent — the unvisited tail is
        all live requests that could only KEEP). Single tenant (or
        fair=False): strict FIFO — the legacy pass. Multiple tenants:
        deficit round-robin."""
        tenants = [jid for jid, q in self._queues.items() if q]
        if len(tenants) <= 1:
            for jid in tenants:
                q = self._queues[jid]
                kept: Deque[LaunchRequest] = deque()
                while q:
                    req = q.popleft()
                    out = try_place(req)
                    if out is _KEEP:
                        kept.append(req)
                    elif out is _GRANT and budget is not None:
                        budget -= 1
                        if not budget:
                            break  # pool spent: stop the pass
                kept.extend(q)  # untried tail keeps FIFO order
                self._queues[jid] = kept
            return
        self._drr_pass(tenants, try_place, budget)

    def _drr_pass(self, tenants: List[str], try_place,
                  budget: Optional[int]) -> None:
        """Deficit round-robin over the tenant rotation (arrival order).
        Each cycle a tenant earns its quantum of container credit and
        serves its queue head-first until a grant spends the credit or
        the head request blocks (no free non-excluded container) — a
        blocked tenant yields the cycle but keeps its place in the
        rotation, so it catches up within the pass once siblings'
        demand drains (the no-starvation property in
        tests/test_dispatch.py). Drops (job done / task completed) cost
        nothing. Unit container cost; quantum defaults to 1.

        Deficit credit is pass-local: a full pass always drains every
        live queue (each cycle moves the head to granted or kept), so
        credit never survives to the next pass — which is also what
        makes the ``budget`` early-stop exact, since the skipped
        keep-churn tail has no carried state to diverge on."""
        kept: Dict[str, Deque[LaunchRequest]] = {
            jid: deque() for jid in tenants}
        deficit: Dict[str, float] = {}
        active: Deque[str] = deque(tenants)
        stop = False
        while active and not stop:
            jid = active.popleft()
            q = self._queues[jid]
            d = deficit.get(jid, 0.0) + self.weights.get(jid, 1.0)
            while q and d >= 1.0:
                req = q.popleft()
                out = try_place(req)
                if out is _GRANT:
                    d -= 1.0
                    if budget is not None:
                        budget -= 1
                        if not budget:
                            stop = True  # pool spent: stop the pass
                            break
                elif out is _KEEP:
                    kept[jid].append(req)
                    break  # head blocked: yield the cycle
            if q and not stop:
                # Carry at most one quantum of credit while blocked —
                # bounded catch-up, not an unbounded burst later.
                deficit[jid] = min(d, self.weights.get(jid, 1.0))
                active.append(jid)
        for jid in tenants:
            q = self._queues[jid]
            if kept[jid]:
                kept[jid].extend(q)  # untried tail keeps FIFO order
                self._queues[jid] = kept[jid]

    # --- shared request logic ------------------------------------------
    def _screen(self, req: LaunchRequest) -> Optional[int]:
        """Drop/cap screening shared by the scalar and bulk passes;
        returns an outcome or None when placement should be attempted."""
        task = req.task
        if task.job.done or task.state == TaskState.COMPLETED:
            self._unindex(task)
            return _DROP
        if len(task.running_attempts()) >= \
                self.sim.params.max_running_attempts:
            # Bugfix: retain the request (metadata and all)
            # until the cap clears, instead of silently dropping it.
            return _KEEP
        return None

    def _grant(self, req: LaunchRequest, node_id: str) -> int:
        sim = self.sim
        self._unindex(req.task)
        self.n_grants += 1
        if sim.obs is not None:
            sim.obs.emit(
                K_DISPATCH, a=sim.cluster._node_pos[node_id],
                b=(1 if req.speculative else 0) |
                  (2 if req.rollback else 0),
                obj=req.reason or None)
        sim._start_attempt(req, node_id)
        return _GRANT

    # --- scalar placement (reference): per-request heap query ----------
    def _try_scalar(self, req: LaunchRequest) -> int:
        out = self._screen(req)
        if out is not None:
            return out
        sim = self.sim
        task = req.task
        exclude = {a.node_id for a in task.running_attempts()}
        exclude |= sim._marked_failed
        self.n_decisions += 1
        node_id = sim.cluster.pick_container(list(req.placement),
                                             exclude=exclude)
        if node_id is None:
            return _KEEP
        return self._grant(req, node_id)

    # --- bulk placement: pass-local free vector + low-water pointer ----
    def _make_bulk_try(self):
        """Build the bulk placement closure for ONE pass. Setup copies
        the columnar ``node_free`` mirror once and zeroes marked-failed
        nodes (excluded for every request, exactly as the scalar pass
        unions ``_marked_failed`` into each exclude set; dead nodes
        already mirror 0 free). Per request the pack-first choice is the
        lowest-index node with local free > 0 that is not a running
        sibling's host — ``Cluster.pick_container``'s documented
        semantics — found by a low-water pointer over the exhausted
        prefix. Grants decrement the local vector; nothing else can
        change free counts mid-pass (attempt construction schedules
        engine events, it never completes work synchronously)."""
        sim = self.sim
        arr = sim.arrays
        free_col = arr.node_free.copy()
        free_col[arr.node_marked] = 0
        # Plain list: the per-request ops below are scalar reads and
        # decrements, where ndarray item access costs several times a
        # list index.
        free = free_col.tolist()
        nidx = arr.node_index
        node_ids = arr.node_ids
        n = len(node_ids)
        state = {"lo": 0}

        def try_place(req: LaunchRequest) -> int:
            out = self._screen(req)
            if out is not None:
                return out
            self.n_decisions += 1
            exclude = {nidx[a.node_id]
                       for a in req.task.running_attempts()}
            for pref in req.placement:
                j = nidx.get(pref)
                if j is not None and free[j] > 0 and j not in exclude:
                    free[j] -= 1
                    return self._grant(req, node_ids[j])
            i = state["lo"]
            while i < n and free[i] <= 0:
                i += 1
            state["lo"] = i  # prefix permanently exhausted this pass
            while i < n and (free[i] <= 0 or i in exclude):
                i += 1
            if i >= n:
                return _KEEP
            free[i] -= 1
            return self._grant(req, node_ids[i])

        return try_place

    # ------------------------------------------------------------------
    def watchdog(self) -> None:
        """AM retry loop: any live task with no running attempt and no
        queued launch gets re-enqueued (covers killed/failed edges).

        With the columnar mirror available, the candidate scan is one
        segmented reduction over the attempt columns
        (:meth:`ArraySnapshot.idle_task_rows`) instead of an
        O(tasks × attempts) object walk per tick; rows arrive in
        canonical §11.3 order, which is exactly the reference loop's
        job-submission → task-creation order, so the enqueue sequence
        is identical (test_columnar's trace gate covers this). The
        queued-launch check is the O(1) ``_queued`` index — the old
        O(pending) set build is gone.
        """
        sim = self.sim
        arr = sim.arrays
        candidates: List["SimTask"] = []
        if arr is not None:
            for r in arr.idle_task_rows():
                candidates.append(arr.owner(r).task)
        else:
            for job in sim.active_jobs.values():
                for t in job.tasks:
                    if t.state == TaskState.RUNNING \
                            and not t.running_attempts():
                        candidates.append(t)
        for t in candidates:
            if t.kind == TaskKind.REDUCE \
                    and not t.job.reduces_scheduled:
                continue
            if t.task_id not in self._queued:
                self.enqueue(LaunchRequest(t, reason="am-watchdog"))
        self.dispatch()
