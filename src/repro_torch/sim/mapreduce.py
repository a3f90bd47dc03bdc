"""YARN MapReduce execution semantics over the discrete-event engine.

Faithfully models the YARN 2.7.1 behaviours that drive the paper's effects:

- NodeManager liveness: RM expires a silent node after ``nm_expiry``
  (default 600 s) — the long fuse behind Fig. 1's small-job slowdowns;
- on node expiry the AM re-runs completed MAP tasks whose MOFs lived only
  there (standard YARN), and reschedules running attempts;
- shuffle fetch failures: a reducer fetching a lost MOF burns a
  ``fetch_cycle`` (Hadoop's 180 s connect/read timeout), reports to the AM,
  and retries; the AM re-runs the producer map after
  ``am_fetch_threshold`` (3) reports — the dependency-oblivious stall;
- reduce slowstart at 5 % map completion; parallel fetchers per reducer;
- speculative attempts ride the pluggable policy (``repro_torch.core``):
  YarnLateSpeculator reproduces the baseline, BinocularSpeculator the paper.

The policy sees the cluster only through ``ClusterSnapshot`` ticks and acts
only through SpeculateTask/KillAttempt/MarkNodeFailed — the same interface
the live training runtime drives.

Layering (DESIGN.md §12): this module owns task/attempt lifecycle and the
AM/RM control decisions. Fetch mechanics live in ``repro_torch.sim.shuffle``
(per-producer ready queues + MOF registry, with the seed's rescan path as
the equivalence reference) and container scheduling in
``repro_torch.sim.dispatch``.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections.abc import Mapping as _Mapping
from typing import (Callable, Dict, List, Optional, Sequence, Set, Tuple,
                    Union)

import numpy as np

from repro_torch.core.arrays import SHUFFLE_FRACTION, ArraySnapshot
from repro_torch.core.rollback import ProgressLog
from repro_torch.core.speculator import BinocularSpeculator, Speculator
from repro_torch.core.types import (
    AttemptState,
    AttemptView,
    ClusterSnapshot,
    FetchFailure,
    KillAttempt,
    MarkNodeFailed,
    NodeView,
    SpeculateTask,
    TaskKind,
    TaskState,
    TaskView,
)
from repro_torch.net.base import make_network
from repro_torch.obs.trace import (
    ACT_KILL,
    ACT_MARK_FAILED,
    ACT_SPECULATE,
    END_COMPLETED,
    END_FAILED,
    END_KILLED,
    FAULT_CODES,
    K_ACTION,
    K_ATT_END,
    K_ATT_START,
    K_DETECT,
    K_FAULT,
    K_ROLLBACK,
    TraceRecorder,
)
from repro_torch.sim.cluster import Cluster, HEARTBEAT_PERIOD
from repro_torch.sim.dispatch import Dispatcher, LaunchRequest
from repro_torch.sim.engine import Engine, EventHandle
from repro_torch.sim.job import JobResult, JobSpec
from repro_torch.sim.shuffle import (ShuffleState, TICK_EXPIRY, TICK_HB,
                               make_engine)

__all__ = [
    "BINO_PARAMS", "LaunchRequest", "SimAttempt", "SimJob", "SimParams",
    "SimTask", "Simulation",
]


@dataclasses.dataclass(frozen=True)
class SimParams:
    """YARN-calibrated timing constants (overridden per policy)."""

    nm_expiry: float = 600.0          # RM NodeManager liveness expiry
    expiry_check: float = 10.0
    heartbeat: float = HEARTBEAT_PERIOD
    spec_interval: float = 1.0        # speculator tick
    slowstart: float = 0.05           # reduce slowstart (fraction of maps)
    am_startup: float = 12.0          # AM negotiation before first launch
    task_overhead: float = 3.0        # container + JVM spin-up per attempt
    fetch_cycle: float = 180.0        # one failed-fetch timeout+report cycle
    am_fetch_threshold: int = 3       # AM re-runs map after N reports...
    # ...but only once ≥ this fraction of the job's RUNNING reduce tasks
    # have reported (Hadoop's too-many-fetch-failures quorum). With few
    # stragglers the quorum shrinks to the running set — the slow fuse.
    am_fetch_quorum: float = 0.5
    # A reduce attempt aborts itself after this many failed fetch cycles
    # (Shuffle EXCEEDED_MAX_FAILURES) — its re-attempt re-shuffles from
    # scratch and "cannot help but wait and encounter several fetch
    # failures again" (§II.D.1).
    reduce_abort_cycles: int = 2
    parallel_fetches: int = 5         # fetchers per reduce attempt
    work_noise: float = 0.08          # lognormal σ on per-attempt work
    max_running_attempts: int = 2     # original + 1 speculative copy
    sim_time_cap: float = 36_000.0


# Binocular speculation pairs its dependency-aware re-execution with
# aggressive shuffle timeouts ("short timeouts", §IV.B.1): a false positive
# only costs one map re-run, whereas YARN's 180 s default guards its
# whole-job churn. The AM threshold stays at YARN's 3; Bino's dependency
# tracker fires first at 2 consecutive failures.
BINO_PARAMS = SimParams(fetch_cycle=60.0)


# Reduce progress split (1/3 shuffle, 2/3 sort+reduce). Single source of
# truth lives next to the columnar progress query it must mirror exactly.
_SHUFFLE_FRAC = SHUFFLE_FRACTION


class SimAttempt:
    def __init__(self, sim: "Simulation", task: "SimTask", node_id: str,
                 *, speculative: bool, rollback: bool, start_offset: float):
        self.sim = sim
        self.task = task
        # Per-simulation counter (not process-global): attempt ids are then
        # reproducible run-to-run, so action traces from two simulations in
        # one process can be compared verbatim (the equivalence gate).
        self.attempt_id = f"{task.task_id}_a{next(sim._attempt_seq)}"
        self.node_id = node_id
        self.state = AttemptState.RUNNING
        self.start_time = sim.engine.now
        self.is_speculative = speculative
        self.is_rollback = rollback
        noise = float(np.exp(sim.rng.normal(0.0, sim.params.work_noise)))
        self.work_total = task.work_seconds * noise + sim.params.task_overhead
        self.work_done = start_offset * self.work_total
        self.last_sync = sim.engine.now
        # Pending milestone/completion timer: an EventHandle on the heap,
        # or an int calendar-lane token for batch-mode map milestones.
        self._milestone: Optional[Union[EventHandle, int]] = None
        # Map-only: progress point where an injected disk exception fires.
        self.disk_exception_at: Optional[float] = None
        # Milestone-ladder cache: (disk_exception_at, points) — the
        # ladder only changes when a disk exception is injected, so the
        # per-spill rescheduling stops rebuilding and re-sorting it.
        self._milestones_cache: Optional[Tuple[Optional[float], list]] = None
        # Reduce-only: shuffle bookkeeping, attached by the shuffle engine.
        self.shuffle: Optional[ShuffleState] = None
        self.compute_started = False
        self.end_time: Optional[float] = None  # completion/failure/kill
        # Columnar mirror row (−1 when the sim runs without ArraySnapshot).
        self.row = -1

    # ------------------------------------------------------------------
    @property
    def node(self):
        return self.sim.cluster.nodes[self.node_id]

    def sync(self) -> None:
        """Fold linear work accrual into ``work_done`` — called at EVENTS
        only (milestones, speed changes, completion), never on reads.
        Keeping reads pure means the simulation's float state is identical
        no matter how often progress is observed, which is what lets the
        columnar mirror stay bit-equal to the object fields."""
        if self.state != AttemptState.RUNNING:
            return  # progress (and last_sync) frozen at end state
        now = self.sim.engine.now
        if self.task.kind == TaskKind.MAP or self.compute_started:
            self.work_done += (now - self.last_sync) * self.node.speed
            self.work_done = min(self.work_done, self.work_total)
        self.last_sync = now
        if self.row >= 0:
            self.sim.arrays.sync_row(self.row, self.work_done, self.last_sync)

    def _work_done_now(self) -> float:
        """Pure read of current work: accrual projected from the last
        event fold, without mutating it."""
        if self.state == AttemptState.RUNNING and (
                self.task.kind == TaskKind.MAP or self.compute_started):
            now = self.sim.engine.now
            return min(self.work_done + (now - self.last_sync)
                       * self.node.speed, self.work_total)
        return self.work_done

    def progress(self) -> float:
        wd = self._work_done_now()
        if self.task.kind == TaskKind.MAP:
            return wd / self.work_total
        n_deps = max(1, len(self.task.deps))
        n_fetched = len(self.shuffle.fetched) if self.shuffle else 0
        shuffle = n_fetched / n_deps
        compute = wd / self.work_total
        return _SHUFFLE_FRAC * shuffle + (1 - _SHUFFLE_FRAC) * compute

    def view(self) -> AttemptView:
        return AttemptView(
            attempt_id=self.attempt_id, task_id=self.task.task_id,
            node_id=self.node_id, state=self.state,
            start_time=self.start_time, progress=self.progress(),
            is_speculative=self.is_speculative,
            is_rollback=self.is_rollback)


class SimTask:
    def __init__(self, sim: "Simulation", job: "SimJob", kind: TaskKind,
                 index: int, work_seconds: float,
                 deps: Tuple[str, ...] = ()):
        self.sim = sim
        self.job = job
        self.kind = kind
        self.index = index
        # Global creation order — the canonical sort key of the columnar
        # rows (matches the reference snapshot's task iteration order).
        self.order = next(sim._task_seq)
        self.task_id = f"{job.spec.job_id}_{kind.value}{index:04d}"
        self.work_seconds = work_seconds
        self.deps = deps
        self._dep_pos: Optional[Dict[str, int]] = None
        self.state = TaskState.PENDING
        self.attempts: List[SimAttempt] = []
        self.output_nodes: List[str] = []
        self.output_available = False
        self.first_start: Optional[float] = None
        self.completed_at: Optional[float] = None
        # AM-side fetch-failure reports against this producer.
        self.fetch_reports = 0
        # One-shot injected disk exception: (progress_fraction,) or None.
        self.inject_disk_exception_at: Optional[float] = None

    @property
    def dep_pos(self) -> Dict[str, int]:
        """Producer task_id → dependency index, shared by every attempt."""
        if self._dep_pos is None:
            self._dep_pos = {m: i for i, m in enumerate(self.deps)}
        return self._dep_pos

    def running_attempts(self) -> List[SimAttempt]:
        return [a for a in self.attempts if a.state == AttemptState.RUNNING]

    def view(self) -> TaskView:
        return TaskView(
            task_id=self.task_id, job_id=self.job.spec.job_id,
            kind=self.kind, state=self.state,
            attempts=[a.view() for a in self.attempts],
            deps=self.deps, output_nodes=tuple(self.output_nodes),
            output_available=self.output_available)


class SimJob:
    def __init__(self, sim: "Simulation", spec: JobSpec):
        self.sim = sim
        self.spec = spec
        self.maps: List[SimTask] = []
        self.reduces: List[SimTask] = []
        self.reduces_scheduled = False
        self.done = False
        self.result: Optional[JobResult] = None
        self.n_spec_attempts = 0
        self.n_attempts = 0
        self.n_fetch_failures = 0
        # COMPLETED map-task count, maintained at the three task-state
        # flip sites (first completion, re-activation of a completed
        # producer in Dispatcher.enqueue / _apply_speculate) so slowstart
        # and the fault triggers stop recounting the map list; verified
        # against a recount in verify_arrays.
        self.n_maps_done = 0
        # Map-progress triggers for fault injection (fraction → callbacks).
        self.map_progress_triggers: List[Tuple[float, Callable]] = []

    @property
    def tasks(self) -> List[SimTask]:
        return self.maps + self.reduces

    def maps_completed(self) -> int:
        return self.n_maps_done

    def map_phase_progress(self) -> float:
        if not self.maps:
            return 1.0
        total = 0.0
        for t in self.maps:
            if t.state == TaskState.COMPLETED:
                total += 1.0
            elif t.running_attempts():
                total += max(a.progress() for a in t.running_attempts())
        return total / len(self.maps)


class _LazyTasks(_Mapping):
    """Materializes ``TaskView`` objects one key at a time.

    The vectorized policies read ``snap.arrays`` and touch this mapping
    only for the rare straggler/dependency cases, so a healthy assessment
    tick allocates no views at all; the per-object reference policies can
    still iterate it and see exactly the eager snapshot (same key order:
    active jobs in submission order, each job's maps then reduces)."""

    def __init__(self, sim: "Simulation"):
        self._sim = sim
        self._cache: Dict[str, TaskView] = {}
        self._keys: Optional[List[str]] = None

    def __getitem__(self, task_id: str) -> TaskView:
        v = self._cache.get(task_id)
        if v is None:
            t = self._sim._task_index.get(task_id)
            if t is None or t.job.spec.job_id not in self._sim.active_jobs:
                raise KeyError(task_id)
            v = t.view()
            self._cache[task_id] = v
        return v

    def _key_list(self) -> List[str]:
        if self._keys is None:
            self._keys = [t.task_id
                          for job in self._sim.active_jobs.values()
                          for t in job.tasks]
        return self._keys

    def __iter__(self):
        return iter(self._key_list())

    def __len__(self) -> int:
        return len(self._key_list())


class _LazyNodes(_Mapping):
    def __init__(self, sim: "Simulation"):
        self._sim = sim
        self._cache: Dict[str, NodeView] = {}

    def __getitem__(self, node_id: str) -> NodeView:
        v = self._cache.get(node_id)
        if v is None:
            n = self._sim.cluster.nodes[node_id]
            v = NodeView(
                node_id=node_id, last_heartbeat=n.last_heartbeat,
                total_containers=n.n_containers,
                free_containers=n.free_containers,
                marked_failed=node_id in self._sim._marked_failed)
            self._cache[node_id] = v
        return v

    def __iter__(self):
        return iter(self._sim.cluster.node_ids)

    def __len__(self) -> int:
        return len(self._sim.cluster.node_ids)


class Simulation:
    """One cluster + one speculation policy + any number of jobs.

    ``columnar=True`` (the default) maintains an incremental
    :class:`~repro_torch.core.arrays.ArraySnapshot` mirror of attempt/node state
    and hands the policies lazy snapshots, activating their vectorized
    assessment paths; ``columnar=False`` rebuilds eager per-object
    snapshots each tick — the reference path the equivalence tests compare
    against. ``shuffle="batch"`` (the default) selects the macro-event
    fetch plane — the indexed ready-queue substrate with fetch timers
    coalesced into the engine's calendar lane (DESIGN.md §14);
    ``shuffle="event"`` the per-event substrate; ``shuffle="rescan"``
    the seed's poll-and-rescan reference. All three emit byte-identical
    traces (DESIGN.md §12.3/§14.3, fuzzed in
    tests/test_fuzz_equivalence.py).
    ``assess_backend`` selects the assessment-compute backend for the
    vectorized policies (None: torch on the CUDA card, the default;
    "numpy"; or a backend instance such as ``TorchBackend("cpu")`` —
    DESIGN.md §13). ``net`` selects the network model ("flat" default: the
    seed-exact quasi-static per-NIC share; "topo": rack-aware with
    oversubscribed uplinks; "fair": batched ε-fair flows re-solved per
    BatchQueue drain — DESIGN.md §15), with ``racks``/``net_opts``
    parameterizing it. ``record_actions=True`` keeps the policy-action
    rail (read back lazily via the ``action_trace`` property) for those
    comparisons; ``obs=TraceRecorder(...)`` additionally wires the
    flight recorder through every subsystem emit site (DESIGN.md §18) —
    glance verdicts with their Eq. 1–4 inputs, attempt lifecycle, drain
    brackets, flow events, fault injections."""

    def __init__(self, *, policy: str = "yarn",
                 policy_factory: Optional[Callable[[Sequence[str]], Speculator]] = None,
                 n_workers: int = 20, n_containers: int = 8,
                 params: Optional[SimParams] = None, seed: int = 0,
                 columnar: bool = True, shuffle: str = "batch",
                 assess_backend: Optional[str] = None,
                 net: object = "flat", racks: int = 0,
                 net_opts: Optional[Dict] = None,
                 dispatch_opts: Optional[Dict] = None,
                 record_actions: bool = False,
                 obs: Optional[TraceRecorder] = None):
        self.engine = Engine()
        # Pluggable network substrate (DESIGN.md §15): "flat" is the
        # seed-exact default; "topo"/"fair" add rack topology and the
        # batched ε-fair flow model. ``racks``/``net_opts`` parameterize
        # the named models; a NetworkModel instance passes through.
        self.cluster = Cluster(
            n_workers, n_containers,
            network=make_network(net, racks=racks, **(net_opts or {})))
        # Nodes whose network link is currently cut (link_cut_at /
        # rack_partition_at) — shared with the MOF registry so cut
        # sources drop out of every engine's candidate scan. Overlapping
        # cut windows union via a per-node depth counter; ``_cut_hb``
        # records the heartbeat-suppression window the active cut owns
        # (so healing never cancels a foreign outage's window).
        self._link_down: Set[str] = set()
        self._cut_depth: Dict[str, int] = {}
        self._cut_hb: Dict[str, float] = {}
        # Active uplink-degrade windows per rack: list of (end, factor);
        # the effective factor is the min over live windows (the
        # strongest degrade), maintained by faults.rack_switch_degrade_at.
        self._degrade_windows: Dict[int, List[Tuple[float, float]]] = {}
        self.rng = np.random.default_rng(seed)
        self.policy_name = policy
        self._attempt_seq = itertools.count()
        self._task_seq = itertools.count()
        self._task_index: Dict[str, SimTask] = {}
        self.arrays: Optional[ArraySnapshot] = (
            ArraySnapshot(self.cluster.node_ids, n_containers)
            if columnar else None)
        if self.arrays is not None:
            self.arrays.init_net(self.cluster.net)
        self.record_actions = record_actions
        # Flight recorder (DESIGN.md §18). An explicitly-passed recorder
        # is wired through every subsystem emit site after construction;
        # record_actions=True alone gets a private actions-only recorder
        # backing the lazy ``action_trace`` property (the seed's
        # unbounded repr-string list is retired — reprs materialize only
        # when an equivalence test reads the property).
        self.obs = obs
        self._act_rec = obs
        if obs is None and record_actions:
            self._act_rec = TraceRecorder()
        if self._act_rec is not None:
            self._act_rec.time_fn = lambda: self.engine.now
        # Assessment-path profiling (benchmarks/perf_scale.py).
        self.assess_ticks = 0
        self.assess_wall = 0.0
        self.actions_emitted = 0
        if params is None:
            params = BINO_PARAMS if policy == "bino" else SimParams()
        self.params = params
        self.assess_backend = assess_backend
        if policy_factory is not None:
            self.speculator = policy_factory(self.cluster.node_ids)
        elif policy == "bino":
            self.speculator = BinocularSpeculator(
                self.cluster.node_ids, assess_backend=assess_backend)
        elif policy == "budgeted":
            # Cross-job speculation under a cluster-wide slot budget
            # (Xu & Lau admission — DESIGN.md §19.3).
            from repro_torch.core.speculator import BudgetedSpeculator
            self.speculator = BudgetedSpeculator(
                total_slots=n_workers * n_containers,
                assess_backend=assess_backend)
        elif policy == "clone":
            # Upfront cloning for small jobs, LATE for the rest
            # (Xu & Lau task-cloning — DESIGN.md §19.3).
            from repro_torch.core.speculator import CloneSmallJobs
            self.speculator = CloneSmallJobs(
                total_slots=n_workers * n_containers,
                assess_backend=assess_backend)
        elif policy == "predictor":
            # Learned straggler nomination over the columnar mirror
            # (DESIGN.md §20); untrained default params degenerate to
            # reap + silent-window failure detection.
            if self.arrays is None:
                raise ValueError(
                    "policy='predictor' requires columnar=True "
                    "(features live in the ArraySnapshot mirror)")
            from repro_torch.predict.policy import PredictorPolicy
            self.speculator = PredictorPolicy(
                self.cluster.node_ids,
                total_slots=n_workers * n_containers,
                assess_backend=assess_backend)
        else:
            from repro_torch.core.speculator import YarnLateSpeculator
            self.speculator = YarnLateSpeculator(
                assess_backend=assess_backend)
        self.jobs: Dict[str, SimJob] = {}
        self.active_jobs: Dict[str, SimJob] = {}
        self.sched = Dispatcher(self, **(dispatch_opts or {}))
        self.shuffle = make_engine(self, shuffle)
        self.attempts: Dict[str, SimAttempt] = {}
        self._fetch_failures: List[FetchFailure] = []
        self._marked_failed: Set[str] = set()
        self.results: List[JobResult] = []
        # ground truth for the Fig. 7(b) accuracy metric
        self.truth_crashed: Set[str] = set()
        self.policy_failed_calls: List[Tuple[float, str]] = []
        self._started = False
        if obs is not None:
            self._wire_obs(obs)

    def _wire_obs(self, rec: TraceRecorder) -> None:
        """Thread the flight recorder through every subsystem emit site
        (DESIGN.md §18.2). Each site pays one ``is not None`` branch when
        a recorder is absent; nothing else changes — the obs-on ≡ obs-off
        byte-identity gate in tests/test_obs.py pins that."""
        rec.time_fn = lambda: self.engine.now
        self.cluster.net.obs = rec
        sp = self.speculator
        sp.obs = rec
        glance = getattr(sp, "glance", None)
        if glance is not None:
            glance.obs = rec
        coll = getattr(sp, "collective", None)
        if coll is not None:
            coll.obs = rec
        lane = getattr(self.shuffle, "batches", None)
        if lane is not None:
            lane.obs = rec

    @property
    def action_trace(self) -> List[Tuple[float, str]]:
        """Lazy ``(time, repr(action))`` materialization from the
        recorder's action rail — read by the trace-equivalence tests;
        empty unless ``record_actions`` (or an ``obs`` recorder) was
        requested."""
        if self._act_rec is None:
            return []
        return [(t, repr(a)) for t, a in self._act_rec.actions()]

    @property
    def pending(self) -> List[LaunchRequest]:
        return self.sched.pending

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    # --- columnar write-through helpers --------------------------------
    def _arr_task_state(self, task: "SimTask") -> None:
        arr = self.arrays
        if arr is not None and task.attempts:
            arr.set_task_state([a.row for a in task.attempts], task.state)

    def _arr_node_free(self, node_id: str) -> None:
        # Free-slot count changed (either direction): refresh the columnar
        # mirror and re-arm the cluster's free-container index.
        self.cluster.note_free(node_id)
        arr = self.arrays
        if arr is not None:
            arr.node_free[arr.node_index[node_id]] = \
                self.cluster.nodes[node_id].free_containers

    def _arr_node_supp(self, node_id: str) -> None:
        # Heartbeat-suppression window changed: refresh the columnar
        # mirror the vectorized RM tick masks against.
        arr = self.arrays
        if arr is not None:
            arr.node_supp[arr.node_index[node_id]] = \
                self.cluster.nodes[node_id].hb_suppressed_until

    def _start_background(self) -> None:
        if self._started:
            return
        self._started = True
        for nid in self.cluster.node_ids:
            self.cluster.nodes[nid].last_heartbeat = self.engine.now
        if self.arrays is not None:
            self.arrays.node_hb[:] = self.engine.now
        # Heartbeat/expiry are high-volume fixed-rate ticks: the shuffle
        # engine decides whether they live on the heap or in the calendar
        # lane (batch mode folds them into the lane as typed records —
        # DESIGN.md §17). The speculator stays on the heap: its actions
        # can complete attempts and flip run(stop=...), which lane
        # records must never do.
        self.shuffle.schedule_tick(self.params.heartbeat, TICK_HB)
        self.engine.after(self.params.spec_interval, self._speculator_tick)
        self.shuffle.schedule_tick(self.params.expiry_check, TICK_EXPIRY)

    def submit(self, spec: JobSpec) -> SimJob:
        job = SimJob(self, spec)
        self.jobs[spec.job_id] = job
        self.engine.at(spec.submit_time, self._launch_job, job)
        return job

    def _launch_job(self, job: SimJob) -> None:
        self._start_background()
        self.active_jobs[job.spec.job_id] = job
        if self.arrays is not None:
            jidx = self.arrays.job_started(job.spec.job_id)
        for i in range(job.spec.n_maps):
            t = SimTask(self, job, TaskKind.MAP, i,
                        job.spec.map_work_seconds())
            job.maps.append(t)
        map_ids = tuple(t.task_id for t in job.maps)
        for i in range(job.spec.reduces):
            t = SimTask(self, job, TaskKind.REDUCE, i,
                        job.spec.reduce_work_seconds(), deps=map_ids)
            job.reduces.append(t)
        for t in job.tasks:
            self._task_index[t.task_id] = t
            if self.arrays is not None:
                self.arrays.task_created(jidx)
        def go():
            for t in job.maps:
                self._enqueue(LaunchRequest(t))
            self._dispatch()
        # AM container negotiation + startup before the first task launches
        self.engine.after(self.params.am_startup, go)

    def run(self) -> List[JobResult]:
        self.engine.run(until=self.params.sim_time_cap,
                        stop=lambda: not self.active_jobs and
                        len(self.results) == len(self.jobs))
        return self.results

    # ------------------------------------------------------------------
    # Scheduling (decisions live in repro_torch.sim.dispatch)
    # ------------------------------------------------------------------
    def _enqueue(self, req: LaunchRequest) -> None:
        self.sched.enqueue(req)

    def _dispatch(self) -> None:
        self.sched.dispatch()

    def _start_attempt(self, req: LaunchRequest, node_id: str) -> None:
        task = req.task
        offset = 0.0
        rollback = False
        if req.rollback and req.rollback_node == node_id:
            node = self.cluster.nodes[node_id]
            offset = node.spill_logs.get(task.task_id, 0.0)
            rollback = offset > 0.0
        a = SimAttempt(self, task, node_id, speculative=req.speculative,
                       rollback=rollback, start_offset=offset)
        if task.kind == TaskKind.MAP and task.inject_disk_exception_at is not None:
            a.disk_exception_at = task.inject_disk_exception_at
            task.inject_disk_exception_at = None  # one-shot
        task.attempts.append(a)
        self.attempts[a.attempt_id] = a
        if task.state == TaskState.PENDING:
            task.state = TaskState.RUNNING
        if task.first_start is None:
            task.first_start = self.engine.now
        task.job.n_attempts += 1
        if req.speculative:
            task.job.n_spec_attempts += 1
        self.cluster.nodes[node_id].busy.add(a.attempt_id)
        if self.obs is not None:
            self.obs.emit(
                K_ATT_START, a=self.cluster._node_pos[node_id],
                b=(1 if req.speculative else 0) | (2 if rollback else 0),
                obj=a.attempt_id)
        arr = self.arrays
        if arr is not None:
            a.row = arr.add_attempt(
                a, a.attempt_id, task.task_id, task.order,
                len(task.attempts) - 1,
                arr.job_index[task.job.spec.job_id],
                arr.node_index[node_id], task.kind, a.is_speculative,
                a.start_time, a.work_done, a.work_total,
                len(task.deps), task.state)
            self._arr_task_state(task)
            self._arr_node_free(node_id)
        if task.kind == TaskKind.MAP:
            self._schedule_map_milestone(a)
        else:
            self.shuffle.attach(a)
            self.shuffle.try_start(a)

    # ------------------------------------------------------------------
    # Map execution: spill milestones, disk exceptions, completion
    # ------------------------------------------------------------------
    def _map_milestones(self, a: SimAttempt) -> List[Tuple[float, str]]:
        cache = a._milestones_cache
        if cache is not None and cache[0] == a.disk_exception_at:
            return cache[1]
        n = a.task.job.spec.n_spills
        pts = [(k / n, "spill") for k in range(1, n)]
        if a.disk_exception_at is not None:
            pts.append((a.disk_exception_at, "disk_exception"))
        pts.append((1.0, "complete"))
        pts.sort()
        a._milestones_cache = (a.disk_exception_at, pts)
        return pts

    def _cancel_timer(self, a: SimAttempt) -> None:
        """Cancel an attempt's pending milestone/completion timer. The
        timer is either a heap EventHandle or (batch-mode map milestones)
        an int lane token — lane cancellation is just forgetting the
        token; the record's applier drops it as stale."""
        h = a._milestone
        if h is not None:
            a._milestone = None
            if type(h) is not int:
                h.cancel()

    def _schedule_map_milestone(self, a: SimAttempt) -> None:
        self._cancel_timer(a)
        if a.state != AttemptState.RUNNING:
            return
        a.sync()
        speed = a.node.speed
        if speed <= 0.0:
            return  # frozen; node death/expiry will clean up
        frac_done = a.work_done / a.work_total
        pts = self._map_milestones(a)
        for idx, (frac, kind) in enumerate(pts):
            if frac > frac_done + 1e-12:
                dt = (frac * a.work_total - a.work_done) / speed
                a._milestone = self.shuffle.schedule_milestone(
                    a, dt, idx, frac, kind)
                return
        # everything already passed (e.g. rollback at 100%): complete now
        a._milestone = self.shuffle.schedule_milestone(
            a, 0.0, pts.index((1.0, "complete")), 1.0, "complete")

    def _map_milestone_fired_idx(self, a: SimAttempt, idx: int) -> None:
        """Lane-record entry point: the record carries the ladder index;
        resolve it against the (cached, stable for a fixed
        disk_exception_at) milestone list."""
        frac, kind = self._map_milestones(a)[idx]
        self._map_milestone_fired(a, frac, kind)

    def _map_milestone_fired(self, a: SimAttempt, frac: float, kind: str) -> None:
        if a.state != AttemptState.RUNNING:
            return
        a.sync()
        if a.work_done + 1e-9 < frac * a.work_total:
            # node slowed down since this event was scheduled; recompute
            self._schedule_map_milestone(a)
            return
        a.work_done = max(a.work_done, frac * a.work_total)
        if a.row >= 0:
            self.arrays.sync_row(a.row, a.work_done, a.last_sync)
        if kind == "spill":
            a.node.spill_logs[a.task.task_id] = max(
                a.node.spill_logs.get(a.task.task_id, 0.0), frac)
            if isinstance(self.speculator, BinocularSpeculator):
                self.speculator.record_progress_log(ProgressLog(
                    task_id=a.task.task_id, node_id=a.node_id, offset=frac))
            self._schedule_map_milestone(a)
        elif kind == "disk_exception":
            self._attempt_failed(a, reason="disk_exception")
        else:
            self._map_completed(a)

    def _obs_att_end(self, a: SimAttempt, code: int) -> None:
        # _work_done_now() is the pure read: the emit must not perturb
        # float state (obs-on/off byte identity, §18.2).
        self.obs.emit(
            K_ATT_END, a=self.cluster._node_pos[a.node_id], b=code,
            f0=a.start_time, f1=a._work_done_now(),
            f2=1.0 if a.is_speculative else 0.0, obj=a.attempt_id)

    def _map_completed(self, a: SimAttempt) -> None:
        task = a.task
        a.state = AttemptState.COMPLETED
        a.end_time = self.engine.now
        if self.obs is not None:
            self._obs_att_end(a, END_COMPLETED)
        a.node.busy.discard(a.attempt_id)
        self._arr_node_free(a.node_id)
        a.node.mofs[task.task_id] = task.job.spec.mof_bytes()
        if a.node_id not in task.output_nodes:
            task.output_nodes.append(a.node_id)
        first_completion = task.state != TaskState.COMPLETED
        if first_completion:
            task.job.n_maps_done += 1
        task.state = TaskState.COMPLETED
        task.output_available = True
        task.fetch_reports = 0
        if task.completed_at is None:
            task.completed_at = self.engine.now
        if a.row >= 0:
            self.arrays.set_attempt_state(a.row, a.state)
            self._arr_task_state(task)
        self._kill_siblings(task, keep=a.attempt_id)
        self.sched.task_done(task)
        # fresh MOF: register the source and notify waiting fetchers
        self.shuffle.on_producer_completed(task, a.node_id)
        if first_completion:
            self._maybe_schedule_reduces(task.job)
            self._check_map_progress_triggers(task.job)
        self._dispatch()

    # ------------------------------------------------------------------
    # Reduce execution: AM-side shuffle hooks, compute
    # (fetch mechanics live in repro_torch.sim.shuffle)
    # ------------------------------------------------------------------
    def _maybe_schedule_reduces(self, job: SimJob) -> None:
        if job.reduces_scheduled or not job.reduces:
            return
        frac = job.maps_completed() / max(1, len(job.maps))
        if frac + 1e-12 >= self.params.slowstart:
            job.reduces_scheduled = True
            for t in job.reduces:
                self._enqueue(LaunchRequest(t))
            self._dispatch()

    def _report_fetch_failure(self, a: SimAttempt, m: str) -> None:
        """A reduce attempt burned a fetch cycle against producer ``m``:
        record it and, past Hadoop's too-many-fetch-failures quorum, give
        up on the MOF and re-run the map."""
        a.task.job.n_fetch_failures += 1
        prod = self._task(m)
        self._fetch_failures.append(FetchFailure(
            time=self.engine.now, consumer_task_id=a.task.task_id,
            producer_task_id=m))
        if prod is not None:
            prod.fetch_reports += 1
            running_reduces = sum(
                1 for t in a.task.job.reduces
                if t.state == TaskState.RUNNING)
            quorum = max(self.params.am_fetch_threshold,
                         int(self.params.am_fetch_quorum * running_reduces))
            if prod.fetch_reports >= quorum and not prod.running_attempts():
                # AM finally gives up on the MOF and re-runs the map.
                prod.fetch_reports = 0
                self._enqueue(LaunchRequest(prod, reason="am-fetch-failures"))
                self._dispatch()

    def _start_compute(self, a: SimAttempt) -> None:
        a.compute_started = True
        a.last_sync = self.engine.now
        if a.row >= 0:
            self.arrays.compute[a.row] = True
            self.arrays.sync_row(a.row, a.work_done, a.last_sync)
        self._schedule_reduce_completion(a)

    def _schedule_reduce_completion(self, a: SimAttempt) -> None:
        # Reduce completions stay on the heap in every mode: completing
        # the last reduce flips run(stop=...), which lane records must
        # never do (BatchQueue contract).
        self._cancel_timer(a)
        if a.state != AttemptState.RUNNING or not a.compute_started:
            return
        a.sync()
        speed = a.node.speed
        if speed <= 0.0:
            return
        dt = (a.work_total - a.work_done) / speed
        a._milestone = self.engine.after(dt, self._reduce_completed, a)

    def _reduce_completed(self, a: SimAttempt) -> None:
        if a.state != AttemptState.RUNNING:
            return
        a.sync()
        if a.work_done < a.work_total - 1e-9:
            self._schedule_reduce_completion(a)
            return
        task = a.task
        a.state = AttemptState.COMPLETED
        a.end_time = self.engine.now
        if self.obs is not None:
            self._obs_att_end(a, END_COMPLETED)
        a.node.busy.discard(a.attempt_id)
        self._arr_node_free(a.node_id)
        task.state = TaskState.COMPLETED
        if task.completed_at is None:
            task.completed_at = self.engine.now
        if a.row >= 0:
            self.arrays.set_attempt_state(a.row, a.state)
            self._arr_task_state(task)
        self._kill_siblings(task, keep=a.attempt_id)
        self.sched.task_done(task)
        self._check_job_done(task.job)
        self._dispatch()

    # ------------------------------------------------------------------
    # Failure/kill handling
    # ------------------------------------------------------------------
    def _attempt_failed(self, a: SimAttempt, reason: str) -> None:
        if a.state != AttemptState.RUNNING:
            return
        if self.obs is not None:
            self._obs_att_end(a, END_FAILED)
        a.state = AttemptState.FAILED
        a.end_time = self.engine.now
        if a.row >= 0:
            self.arrays.set_attempt_state(a.row, a.state)
        self._teardown_attempt(a)
        task = a.task
        if task.state == TaskState.COMPLETED or task.job.done:
            return
        if not task.running_attempts():
            # AM failover: policy decides the recovery shape (rollback
            # race for Bino, plain re-attempt for YARN).
            for req in self._recovery_requests(task, a, reason):
                self._enqueue(req)
            self._dispatch()

    def _recovery_requests(self, task: SimTask, failed: SimAttempt,
                           reason: str) -> List[LaunchRequest]:
        node = self.cluster.nodes[failed.node_id]
        use_rollback = (
            isinstance(self.speculator, BinocularSpeculator)
            and self.speculator.cfg.rollback_enabled
            and task.kind == TaskKind.MAP
            and node.alive
            and failed.node_id not in self._marked_failed
            and node.spill_logs.get(task.task_id, 0.0) > 0.0)
        if use_rollback:
            if self.obs is not None:
                self.obs.emit(
                    K_ROLLBACK, a=self.cluster._node_pos[failed.node_id],
                    f0=node.spill_logs.get(task.task_id, 0.0),
                    obj=task.task_id)
            return [
                LaunchRequest(task, placement=(failed.node_id,),
                              rollback=True, rollback_node=failed.node_id,
                              reason=reason + "+rollback"),
                LaunchRequest(task, reason=reason),
            ]
        return [LaunchRequest(task, reason=reason)]

    def _kill_attempt(self, a: SimAttempt, reason: str = "") -> None:
        if a.state != AttemptState.RUNNING:
            return
        if self.obs is not None:
            self._obs_att_end(a, END_KILLED)
        a.state = AttemptState.KILLED
        a.end_time = self.engine.now
        if a.row >= 0:
            self.arrays.set_attempt_state(a.row, a.state)
        self._teardown_attempt(a)

    def _kill_siblings(self, task: SimTask, keep: str) -> None:
        for a in task.attempts:
            if a.attempt_id != keep:
                self._kill_attempt(a, "sibling completed")

    def _teardown_attempt(self, a: SimAttempt) -> None:
        a.node.busy.discard(a.attempt_id)
        self._arr_node_free(a.node_id)
        self._cancel_timer(a)
        self.shuffle.detach(a)

    # ------------------------------------------------------------------
    # Node lifecycle (RM view)
    # ------------------------------------------------------------------
    def node_lost(self, node_id: str, *, by_policy: bool = False) -> None:
        """RM declares a node dead (NM expiry or MarkNodeFailed action)."""
        if node_id in self._marked_failed:
            return
        self._marked_failed.add(node_id)
        if self.obs is not None:
            self.obs.emit(K_DETECT, a=self.cluster._node_pos[node_id],
                          b=1 if by_policy else 0)
        node = self.cluster.nodes[node_id]
        # Its MOF copies stop being fetchable the moment the RM marks it.
        self.shuffle.registry.drop_node_sources(node)
        if self.arrays is not None:
            self.arrays.node_marked[self.arrays.node_index[node_id]] = True
        if by_policy:
            self.policy_failed_calls.append((self.engine.now, node_id))
        # Running attempts there are gone.
        for a in list(self.attempts.values()):
            if a.node_id == node_id and a.state == AttemptState.RUNNING:
                self._attempt_failed(a, reason="node-lost")
            # In-flight fetches FROM the dead node fail over to a cycle.
            if a.state == AttemptState.RUNNING and a.shuffle is not None:
                for m, src in list(a.shuffle.fetch_srcs.items()):
                    if src == node_id:
                        self.shuffle.abort_fetch(a, m)
                        self.shuffle.try_start(a)
        # Completed maps whose only MOF copies lived there must re-run
        # (standard YARN on node expiry) — unless every reducer already
        # fetched that partition. The placement index yields exactly the
        # producers with an output copy here, in map creation order.
        reg = self.shuffle.registry
        for t in reg.take_placed(node_id):
            if t.state != TaskState.COMPLETED:
                reg.keep_placed(node_id, t)  # re-running; not YARN's case
                continue
            t.output_nodes = [n for n in t.output_nodes if n != node_id]
            if not t.output_nodes:
                t.output_available = False
                if self.shuffle.someone_still_needs(t) and \
                        not t.running_attempts():
                    self._enqueue(LaunchRequest(
                        t, reason="node-lost-mof"))
        node.mofs.clear()
        node.spill_logs.clear()
        if isinstance(self.speculator, BinocularSpeculator):
            self.speculator.rollback.drop_node(node_id)
        self._dispatch()

    def lose_mof(self, prod: SimTask) -> None:
        """Silently delete every copy of a completed map's MOF (disk-level
        loss; the node stays healthy). In-flight transfers of that
        partition abort; task bookkeeping still believes the output exists
        — only subsequent fetches discover the loss."""
        if self.obs is not None:
            self.obs.emit(K_FAULT, a=-1, b=FAULT_CODES["mof"],
                          obj=prod.task_id)
        for nid in list(prod.output_nodes):
            self.cluster.nodes[nid].mofs.pop(prod.task_id, None)
        self.shuffle.registry.drop_producer(prod.task_id)
        for a in list(self.attempts.values()):
            if a.state != AttemptState.RUNNING or a.shuffle is None \
                    or prod.task_id not in a.shuffle.inflight:
                continue
            self.shuffle.abort_fetch(a, prod.task_id)
            self.shuffle.try_start(a)  # rediscovers via a failure cycle

    def cut_link(self, node_id: str,
                 duration: Optional[float] = None) -> None:
        """Network link fault (DESIGN.md §15.5): the node keeps computing
        but its fetch paths and heartbeats are gone. In-flight transfers
        touching the node abort — consumers fall into failure cycles
        (the recovery machinery the paper studies) rather than stretching
        a transfer toward infinity — and its MOF copies leave every
        engine's candidate set until :meth:`restore_link`. Overlapping
        cut windows union: the link heals only when every window has
        been restored (depth counter), and heartbeat suppression only
        ever extends — a cut never shortens a window someone else
        (an outage, an earlier cut) already installed."""
        node = self.cluster.nodes[node_id]
        if self.obs is not None:
            self.obs.emit(K_FAULT, a=self.cluster._node_pos[node_id],
                          b=FAULT_CODES["cut"],
                          f0=duration if duration is not None else 0.0)
        target = (self.engine.now + duration if duration is not None
                  else float("inf"))
        if target > node.hb_suppressed_until:
            node.hb_suppressed_until = target
            self._arr_node_supp(node_id)
            # remember the window this cut owns so restore can tell it
            # apart from a foreign (outage-installed) window
            self._cut_hb[node_id] = target
        depth = self._cut_depth.get(node_id, 0)
        self._cut_depth[node_id] = depth + 1
        if depth:
            return  # already down: deepen the window, effects already ran
        self._link_down.add(node_id)
        self.cluster.net.cut(node_id)
        # Its MOF copies stop being fetchable while the link is down.
        self.shuffle.registry.drop_node_sources(node)
        # The cut host's own in-flight fetches stall out silently (same
        # shape as crash_node: no immediate retry — the next producer
        # completion in the job re-kicks the attempt).
        for a in self.attempts.values():
            if a.node_id == node_id and a.state == AttemptState.RUNNING \
                    and a.shuffle is not None and a.shuffle.inflight:
                for m in list(a.shuffle.inflight):
                    self.shuffle.abort_fetch(a, m)
                self.shuffle.mark_stalled(a)
        # Fetches streaming FROM the cut node stall into failure cycles.
        for a in self.attempts.values():
            if a.state != AttemptState.RUNNING or a.node_id == node_id \
                    or a.shuffle is None:
                continue
            for m, src in list(a.shuffle.fetch_srcs.items()):
                if src == node_id:
                    self.shuffle.abort_fetch(a, m)
                    self.shuffle.try_start(a)

    def restore_link(self, node_id: str) -> None:
        """One cut window ends: the link heals only once every
        overlapping window is restored. Heartbeats resume on the next
        RM tick — unless a foreign suppression (a heartbeat outage, or
        a longer window installed mid-cut) still owns the clock — and
        the node's surviving MOF copies rejoin the registry (waiting
        reducers rediscover them on their next failure-cycle retry —
        no eager notify, matching the reference scan's behavior)."""
        depth = self._cut_depth.get(node_id, 0)
        if depth == 0:
            return
        if depth > 1:
            self._cut_depth[node_id] = depth - 1
            return
        del self._cut_depth[node_id]
        self._link_down.discard(node_id)
        self.cluster.net.restore_link(node_id)
        node = self.cluster.nodes[node_id]
        owned = self._cut_hb.pop(node_id, None)
        if owned is not None and node.hb_suppressed_until == owned \
                and owned > self.engine.now:
            node.hb_suppressed_until = self.engine.now
            self._arr_node_supp(node_id)
        if node.alive:
            for task_id in node.mofs:
                t = self._task(task_id)
                if t is not None and t.state == TaskState.COMPLETED \
                        and node_id in t.output_nodes:
                    self.shuffle.registry.add(t, node_id)

    def set_node_speed(self, node_id: str, speed: float) -> None:
        """Sync every hosted attempt at the OLD speed, flip, reschedule."""
        node = self.cluster.nodes[node_id]
        if self.obs is not None and 0.0 < speed < 1.0:
            # A slowdown fault (crash emits its own record at speed 0;
            # restoring to 1.0 is recovery, not a fault).
            self.obs.emit(K_FAULT, a=self.cluster._node_pos[node_id],
                          b=FAULT_CODES["slow"], f0=speed)
        hosted = [a for a in self.attempts.values()
                  if a.node_id == node_id and a.state == AttemptState.RUNNING]
        for a in hosted:
            a.sync()
        node.speed = speed
        if self.arrays is not None:
            self.arrays.node_speed[self.arrays.node_index[node_id]] = speed
        for a in hosted:
            if a.task.kind == TaskKind.MAP:
                self._schedule_map_milestone(a)
            elif a.compute_started:
                self._schedule_reduce_completion(a)

    def crash_node(self, node_id: str) -> None:
        """Ground-truth crash: heartbeats stop, disk contents gone.
        Attempts keep their frozen progress; RM/policy must DISCOVER the
        death (that discovery latency is the paper's whole subject)."""
        node = self.cluster.nodes[node_id]
        if self.obs is not None:
            self.obs.emit(K_FAULT, a=self.cluster._node_pos[node_id],
                          b=FAULT_CODES["crash"])
        self.truth_crashed.add(node_id)
        self.set_node_speed(node_id, 0.0)
        self.shuffle.registry.drop_node_sources(node)
        node.fail()
        if self.arrays is not None:
            self.arrays.node_alive[self.arrays.node_index[node_id]] = False
        self._arr_node_free(node_id)
        # The crashed host's own in-flight fetches stall out silently: no
        # immediate retry — the next producer completion in the job
        # re-kicks the attempt (mark_stalled keeps the event engine's
        # notification set equal to the rescan broadcast here).
        for a in self.attempts.values():
            if a.node_id == node_id and a.state == AttemptState.RUNNING \
                    and a.shuffle is not None and a.shuffle.inflight:
                for m in list(a.shuffle.inflight):
                    self.shuffle.abort_fetch(a, m)
                self.shuffle.mark_stalled(a)
        # Fetches streaming FROM the crashed node stall into failure cycles.
        for a in self.attempts.values():
            if a.state != AttemptState.RUNNING or a.node_id == node_id \
                    or a.shuffle is None:
                continue
            for m, src in list(a.shuffle.fetch_srcs.items()):
                if src == node_id:
                    self.shuffle.abort_fetch(a, m)
                    self.shuffle.try_start(a)

    def restore_node(self, node_id: str) -> None:
        node = self.cluster.nodes[node_id]
        # Whatever was running there is long gone.
        for a in list(self.attempts.values()):
            if a.node_id == node_id and a.state == AttemptState.RUNNING:
                self._attempt_failed(a, reason="node-restarted")
        node.restore()
        node.last_heartbeat = self.engine.now
        self.cluster.net.node_reset(node_id)
        self.cluster.note_free(node_id)
        self._marked_failed.discard(node_id)
        self.truth_crashed.discard(node_id)
        if self.arrays is not None:
            i = self.arrays.node_index[node_id]
            self.arrays.node_speed[i] = node.speed
            self.arrays.node_hb[i] = node.last_heartbeat
            self.arrays.node_marked[i] = False
            self.arrays.node_alive[i] = True
            self.arrays.node_free[i] = node.free_containers
        if hasattr(self.speculator, "glance"):
            self.speculator.glance.reset_node(node_id)
        self._dispatch()

    # ------------------------------------------------------------------
    # Background ticks
    # ------------------------------------------------------------------
    def _heartbeat_tick(self) -> None:
        now = self.engine.now
        arr = self.arrays
        marked = self._marked_failed
        if arr is not None and not marked:
            # Vectorized RM tick (DESIGN.md §17.5): the all-healthy
            # common case is one mask over the liveness/suppression
            # mirrors; only the heartbeating rows' python attrs sync.
            idx = np.flatnonzero(arr.node_alive & (arr.node_supp <= now))
            arr.node_hb[idx] = now
            nodes = self.cluster.nodes
            ids = self.cluster.node_ids
            for i in idx.tolist():
                nodes[ids[i]].last_heartbeat = now
        else:
            # Reference loop: no columnar mirror, or a misjudged-dead
            # node whose rejoin needs the per-node ``marked`` check.
            hb = arr.node_hb if arr is not None else None
            for i, node in enumerate(self.cluster.nodes.values()):
                if node.alive and now >= node.hb_suppressed_until:
                    node.last_heartbeat = now
                    if hb is not None:
                        hb[i] = now
                    if marked and node.node_id in marked:
                        # transient outage misjudged as failure: NM rejoins
                        marked.discard(node.node_id)
                        if arr is not None:
                            arr.node_marked[i] = False
        if self.active_jobs or len(self.results) < len(self.jobs):
            self.shuffle.schedule_tick(self.params.heartbeat, TICK_HB)

    def _expiry_tick(self) -> None:
        now = self.engine.now
        arr = self.arrays
        if arr is not None:
            # Columnar fast path: ``node_hb`` mirrors every node's
            # last_heartbeat, so the common all-healthy tick is one
            # vectorized comparison; stale rows fall back to the exact
            # per-node checks in index (= dict) order.
            stale = np.flatnonzero(now - arr.node_hb > self.params.nm_expiry)
            nodes = [self.cluster.node_ids[i] for i in stale]
        else:
            nodes = self.cluster.nodes
        for nid in nodes:
            node = self.cluster.nodes[nid]
            if node.node_id in self._marked_failed:
                continue
            if now - node.last_heartbeat > self.params.nm_expiry:
                self.node_lost(node.node_id)
        if self.active_jobs or len(self.results) < len(self.jobs):
            self.shuffle.schedule_tick(self.params.expiry_check, TICK_EXPIRY)

    def _speculator_tick(self) -> None:
        self.sched.watchdog()
        t0 = time.perf_counter()
        snap = self._snapshot()
        actions = self.speculator.assess(snap)
        self.assess_wall += time.perf_counter() - t0
        self.assess_ticks += 1
        self.actions_emitted += len(actions)
        rec = self._act_rec
        if rec is not None and actions:
            pos = self.cluster._node_pos
            for act in actions:
                if isinstance(act, MarkNodeFailed):
                    code, nid = ACT_MARK_FAILED, act.node_id
                elif isinstance(act, SpeculateTask):
                    code, nid = ACT_SPECULATE, self._spec_victim(act)
                else:
                    code = ACT_KILL
                    att = self.attempts.get(act.attempt_id)
                    nid = att.node_id if att is not None else None
                rec.emit(K_ACTION, a=pos.get(nid, -1), b=code, obj=act)
        self._fetch_failures.clear()
        for act in actions:
            if isinstance(act, MarkNodeFailed):
                self.node_lost(act.node_id, by_policy=True)
            elif isinstance(act, KillAttempt):
                a = self.attempts.get(act.attempt_id)
                if a is not None:
                    self._kill_attempt(a, act.reason)
            elif isinstance(act, SpeculateTask):
                self._apply_speculate(act)
        self._dispatch()
        if self.active_jobs or len(self.results) < len(self.jobs):
            self.engine.after(self.params.spec_interval,
                              self._speculator_tick)

    def _spec_victim(self, act: SpeculateTask) -> Optional[str]:
        """Node a SpeculateTask implicates: where the task's current
        attempt runs (trace labeling only — never feeds decisions)."""
        task = self._task(act.task_id)
        if task is None:
            return None
        running = task.running_attempts()
        return running[0].node_id if running else None

    def _apply_speculate(self, act: SpeculateTask) -> None:
        task = self._task(act.task_id)
        if task is None or task.job.done:
            return
        if self.sched.has_queued(task):
            return  # a launch for this task is already queued
        if task.state == TaskState.COMPLETED:
            # dependency-aware re-execution of a completed producer;
            # both outputs are kept until job completion (§III.B).
            if task.running_attempts():
                return
            if task.kind == TaskKind.MAP:
                task.job.n_maps_done -= 1
            task.state = TaskState.RUNNING
            self._arr_task_state(task)
            self._enqueue(LaunchRequest(
                task, placement=act.placement_hint, reason=act.reason))
            return
        if len(task.running_attempts()) >= self.params.max_running_attempts:
            return
        self._enqueue(LaunchRequest(
            task, placement=act.placement_hint, speculative=True,
            rollback=act.rollback, rollback_node=act.rollback_node,
            reason=act.reason))

    # ------------------------------------------------------------------
    # Snapshot + bookkeeping
    # ------------------------------------------------------------------
    def _task(self, task_id: str) -> Optional[SimTask]:
        return self._task_index.get(task_id)

    def _snapshot(self) -> ClusterSnapshot:
        if self.arrays is not None:
            # Columnar tick: the policies read the incrementally-maintained
            # arrays; the mappings materialize per-object views only if a
            # (rare) straggler/dependency path actually touches them.
            return ClusterSnapshot(
                now=self.engine.now, nodes=_LazyNodes(self),
                tasks=_LazyTasks(self),
                fetch_failures=tuple(self._fetch_failures),
                arrays=self.arrays)
        nodes = {}
        for nid, n in self.cluster.nodes.items():
            nodes[nid] = NodeView(
                node_id=nid, last_heartbeat=n.last_heartbeat,
                total_containers=n.n_containers,
                free_containers=n.free_containers,
                marked_failed=nid in self._marked_failed)
        tasks = {}
        for job in self.active_jobs.values():
            for t in job.tasks:
                tasks[t.task_id] = t.view()
        return ClusterSnapshot(
            now=self.engine.now, nodes=nodes, tasks=tasks,
            fetch_failures=tuple(self._fetch_failures))

    def verify_arrays(self) -> None:
        """Assert the incrementally-maintained columns equal a from-scratch
        rebuild from the object state (the equivalence gate's second half;
        tests call this mid-run after each event type)."""
        arr = self.arrays
        assert arr is not None, "simulation runs without columnar mirror"
        from repro_torch.core.arrays import ASTATE, KIND, TSTATE
        for i, nid in enumerate(self.cluster.node_ids):
            node = self.cluster.nodes[nid]
            assert arr.node_hb[i] == node.last_heartbeat, nid
            assert arr.node_speed[i] == node.speed, nid
            assert arr.node_free[i] == node.free_containers, nid
            assert bool(arr.node_marked[i]) == (nid in self._marked_failed), nid
            assert bool(arr.node_alive[i]) == node.alive, nid
            assert arr.node_supp[i] == node.hb_suppressed_until, nid
            assert arr.node_flows[i] == node.active_flows, nid
            assert bool(arr.node_link_up[i]) == (nid not in self._link_down), \
                nid
        self.verify_network()
        for job in self.active_jobs.values():
            recount = sum(1 for t in job.maps
                          if t.state == TaskState.COMPLETED)
            assert job.n_maps_done == recount, \
                (job.spec.job_id, job.n_maps_done, recount)
        expected = [(a, t, job) for job in self.active_jobs.values()
                    for t in job.tasks for a in t.attempts]
        live = arr.rows_where(arr.active[:arr.n])
        assert len(live) == len(expected), (len(live), len(expected))
        now = self.engine.now
        prog = arr.progress_at(now, live)
        for k, (r, (a, t, job)) in enumerate(zip(live, expected)):
            assert arr.attempt_ids[r] == a.attempt_id
            assert arr.task_ids[r] == t.task_id
            assert a.row == r
            assert arr.a_state[r] == ASTATE[a.state]
            assert arr.t_state[r] == TSTATE[t.state]
            assert arr.kind[r] == KIND[t.kind]
            assert arr.job_ids[arr.job[r]] == job.spec.job_id
            assert arr.node_ids[arr.node[r]] == a.node_id
            assert bool(arr.spec[r]) == a.is_speculative
            assert arr.start[r] == a.start_time
            assert arr.work_done[r] == a.work_done
            assert arr.work_total[r] == a.work_total
            assert arr.last_sync[r] == a.last_sync
            assert arr.deps[r] == max(1, len(t.deps))
            assert bool(arr.compute[r]) == a.compute_started
            ss = a.shuffle
            if ss is not None:
                assert arr.fetched[r] == len(ss.fetched)
                assert arr.sh_ready[r] == ss.n_ready
                assert arr.sh_inflight[r] == len(ss.inflight)
                assert arr.sh_fail[r] == len(ss.fail_cycles)
                if a.state == AttemptState.RUNNING:
                    self.shuffle.verify_state(a)
            else:
                assert arr.fetched[r] == 0
                assert arr.sh_ready[r] == 0
                assert arr.sh_inflight[r] == 0
                assert arr.sh_fail[r] == 0
            if a.state == AttemptState.RUNNING:
                self.shuffle.verify_timer(a)
            assert prog[k] == a.progress(), (a.attempt_id, prog[k],
                                             a.progress())

    def verify_network(self) -> None:
        """Assert the network model's incrementally-maintained flow and
        link counters equal a from-scratch recount of the live transfers
        (the §15 half of the write-through gate; works with or without
        the columnar mirror)."""
        flows = []
        for a in self.attempts.values():
            if a.state == AttemptState.RUNNING and a.shuffle is not None:
                for src in a.shuffle.fetch_srcs.values():
                    flows.append((src, a.node_id))
        self.cluster.net.verify(flows, self._link_down)

    def _check_map_progress_triggers(self, job: SimJob) -> None:
        if not job.map_progress_triggers:
            return
        frac = job.maps_completed() / max(1, len(job.maps))
        fired = [x for x in job.map_progress_triggers if frac + 1e-12 >= x[0]]
        job.map_progress_triggers = [
            x for x in job.map_progress_triggers if frac + 1e-12 < x[0]]
        for _, fn in fired:
            fn()

    def _check_job_done(self, job: SimJob) -> None:
        if job.done:
            return
        # YARN job completion = every reduce task committed. Outstanding
        # map re-runs (lost-MOF recoveries) are moot once consumers are
        # done; they are killed below.
        if all(t.state == TaskState.COMPLETED for t in job.reduces):
            job.done = True
            self.sched.job_done(job.spec.job_id)
            for t in job.tasks:
                for a in t.running_attempts():
                    self._kill_attempt(a, "job done")
            durations = [
                (t.completed_at - t.first_start)
                for t in job.tasks
                if t.completed_at is not None and t.first_start is not None]
            job.result = JobResult(
                job_id=job.spec.job_id, bench=job.spec.bench,
                input_gb=job.spec.input_gb,
                submit_time=job.spec.submit_time,
                finish_time=self.engine.now,
                n_spec_attempts=job.n_spec_attempts,
                n_attempts=job.n_attempts,
                n_fetch_failures=job.n_fetch_failures,
                task_durations=durations)
            self.results.append(job.result)
            self.active_jobs.pop(job.spec.job_id, None)
            if self.arrays is not None:
                self.arrays.job_finished(job.spec.job_id)
            self.shuffle.on_job_done(job)
            self.speculator.job_done(job.spec.job_id)
            # Prune the global attempt index (stress runs submit hundreds
            # of jobs; node_lost scans this dict).
            for t in job.tasks:
                for a in t.attempts:
                    self.attempts.pop(a.attempt_id, None)
