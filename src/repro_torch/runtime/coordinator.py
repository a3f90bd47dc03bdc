"""Training coordinator: the global speculator's seat (paper §III → live
training, DESIGN.md §2 mapping, chaos hardening §16), copied from the
reference's ``repro/runtime/coordinator.py`` except for the reduce, which
sums the gradient tensors where they lie (the card) in the reference's
order.

One training step is a MapReduce round:
- map tasks   — per-shard microbatch gradient production on host daemons,
                streamed eagerly to the coordinator (the "MOF" is consumer-
                side the moment it exists, so a producer's death loses only
                its UNSTREAMED microbatches);
- reduce task — the deterministic ordered gradient sum + optimizer apply,
                dependent on every shard's stream (the barrier).

The policy engine (``repro_torch.core``) sees this through the same
ClusterSnapshot/Action protocol as the MapReduce simulator — and through
the same *columnar* substrate: the coordinator maintains an
incrementally-written :class:`~repro_torch.core.arrays.ArraySnapshot`
whose node columns are built from live heartbeats, so assessment runs
through the pluggable ``repro_torch.accel`` backends — by default the
card's kernels B1–B4 — exactly as in the simulator (one
assessment engine, two frontends). ``verify_columnar=True`` additionally
runs the per-object reference engine on every tick's snapshot and asserts
action-for-action agreement — the sim-vs-runtime differential gate.

Recovery strategies:

- ``bino``     — BinocularSpeculator: Eq. 4 adaptive failure detection,
                 neighborhood/temporal straggler glance, collective shadow
                 attempts, rollback resume from the (shard, mb, DataState)
                 progress log. Only missing microbatches are re-executed.
- ``restart``  — the gang-restart baseline: a silent host past the long
                 timeout (or a stalled gradient stream) aborts the step;
                 all partial gradients are discarded and the step re-runs
                 on survivors.

Hardened communication paths (DESIGN.md §16.5): work items are delivered
at-least-once — every assign is acked, unacked sends are redelivered
under a deadline with jittered exponential backoff (bounded; exhaustion
fails the attempt over to another host), and hosts dedup redeliveries.
Dropped results are repaired by coverage accounting: a task is complete
only when its shard's gradient coverage is, and a stalled incomplete
task is resumed from the first missing microbatch (never by trusting an
attempt's own "done" claim, which can vanish in transit). If a step
still wedges past its deadline, or the live-host set falls below quorum,
the step is rolled back to its in-memory commit point (model state only
mutates on step success) and retried; ``step_retry_limit`` exhaustion
raises :class:`StepWedged`, which the TrainerRuntime turns into a
durable rollback from the last checkpoint.

Exactly-once invariant: gradients are keyed by (shard, microbatch); the
first arrival wins, duplicates from racing speculative attempts (or a
chaos layer re-delivering messages) are dropped, and the final sum runs
in sorted key order — a faulted run's model update is bit-identical to a
fault-free run's.

All time flows through an injectable Clock (repro_torch.runtime.clock), so the
chaos matrix runs on compressed virtual time without racing real sleeps.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import queue
import random
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple


from repro_torch.core import (
    AttemptState,
    AttemptView,
    BinoConfig,
    BinocularSpeculator,
    ClusterSnapshot,
    KillAttempt,
    MarkNodeFailed,
    NodeView,
    ProgressLog,
    SpeculateTask,
    TaskKind,
    TaskState,
    TaskView,
)
from repro_torch.core.arrays import ArraySnapshot
from repro_torch.core.collective import CollectiveConfig
from repro_torch.core.glance import GlanceConfig
from repro_torch.data.pipeline import DataState
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import (
    END_COMPLETED,
    END_FAILED,
    END_KILLED,
    K_ATT_END,
    K_ATT_START,
    K_DETECT,
    K_ROLLBACK,
)
from repro_torch.runtime.clock import Clock, SystemClock
from repro_torch.runtime.hosts import (
    AckMessage,
    GradMessage,
    HostDaemon,
    ProgressMessage,
    WorkItem,
)


class StepWedged(RuntimeError):
    """A step exhausted its in-memory rollback retries (quorum loss or a
    persistent wedge); the caller should fall back to a durable rollback
    (checkpoint restore) or surface the failure."""

    def __init__(self, step: int, detail: str = ""):
        super().__init__(f"step {step} wedged{': ' + detail if detail else ''}")
        self.step = step


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    n_hosts: int = 4
    microbatches_per_shard: int = 8
    recovery: str = "bino"            # "bino" | "restart"
    heartbeat_period: float = 0.05
    spec_interval: float = 0.15
    # gang-restart baseline: host silent (or gradient stream stalled) past
    # this ⇒ abort + restart step
    restart_timeout: float = 6.0
    # per-microbatch artificial compute time (gives tiny test models a
    # realistic timeline; 0 for pure-throughput runs)
    compute_delay: float = 0.05
    checkpoint_every: int = 0         # 0 = off
    checkpoint_dir: Optional[str] = None
    # --- hardened comms (DESIGN.md §16.5) ------------------------------
    ack_timeout: float = 0.3          # unacked assign past this ⇒ resend
    send_retries: int = 4             # bounded; exhaustion fails over
    backoff_base: float = 0.1         # jittered exponential backoff
    backoff_cap: float = 2.0
    backoff_jitter: float = 0.25
    # incomplete task with no freshly-reporting attempt past this ⇒
    # rollback relaunch from the first missing microbatch (bino only)
    repair_timeout: float = 1.0
    quorum_frac: float = 0.5          # live < ceil(frac·n) ⇒ step rollback
    step_retry_limit: int = 3         # in-memory rollback resumes per step
    step_deadline: float = 0.0        # 0 = auto: max(60, 30·restart_timeout)
    seed: int = 0                     # backoff jitter RNG
    # --- columnar assessment path (DESIGN.md §16.6) --------------------
    assess_columnar: bool = True      # feed policies ArraySnapshot columns
    # repro_torch.accel backend: None = torch on the card (B1–B4; raises
    # without one); CPU runs pass "numpy" or TorchBackend("cpu")
    assess_backend: Any = None
    verify_columnar: bool = False     # differential: reference ≡ columnar
    # Alternative speculator under recovery="bino" plumbing: a callable
    # ``host_ids -> Speculator`` (e.g. a trained PredictorPolicy,
    # DESIGN.md §20). Learned policies (``learned = True``) skip the
    # verify_columnar reference shadow — their verdicts legitimately
    # differ from BinocularSpeculator's.
    speculator_factory: Optional[Callable[[Sequence[str]], Any]] = None

    def glance(self) -> GlanceConfig:
        return GlanceConfig(
            fail_threshold_init=1.0, fail_threshold_min=0.4,
            fail_threshold_max=8.0, temporal_period=0.3,
            size_neighbor=min(4, max(2, self.n_hosts)),
            spatial_consecutive=3,
            responsive_window=4 * self.heartbeat_period)


@dataclasses.dataclass
class _AttemptRec:
    attempt_id: str
    task_id: str
    host_id: str
    start: float
    mb_start: int
    mb_total: int
    mb_done: int = 0
    state: AttemptState = AttemptState.RUNNING
    speculative: bool = False
    rollback: bool = False
    end: float = 0.0
    last_seen: float = 0.0    # last grad/progress arrival (liveness)
    row: int = -1             # columnar mirror row (compaction re-targets)


@dataclasses.dataclass
class StepReport:
    step: int
    wall_s: float
    mb_executed: int          # total microbatch executions incl. waste
    mb_needed: int
    recoveries: List[str]
    restarts: int
    metrics: Dict[str, float]
    wedges: int = 0           # in-memory rollback resumes taken


class Coordinator:
    def __init__(self, cfg: RuntimeConfig, *, grad_fn, apply_fn, batch_fn,
                 init_state, datastates: Sequence[DataState],
                 clock: Optional[Clock] = None, chaos=None,
                 obs=None, metrics: Optional[MetricsRegistry] = None):
        self.cfg = cfg
        self.grad_fn = grad_fn
        self.apply_fn = apply_fn          # (state, summed_grads) -> state
        self.batch_fn = batch_fn
        self.state = init_state
        self.n_shards = len(datastates)
        self.datastates: List[DataState] = list(datastates)
        self.clock: Clock = clock if clock is not None else SystemClock()
        self.chaos = chaos
        self.queue: "queue.Queue" = queue.Queue()
        self.hosts: Dict[str, HostDaemon] = {}
        self.heartbeats: Dict[str, float] = {}
        self._hb_lock = threading.Lock()
        self.dead_hosts: Set[str] = set()
        self._aid = itertools.count()
        self._task_order = itertools.count()
        self._rng = random.Random(cfg.seed)
        # at-least-once assign delivery: attempt_id -> in-flight send
        self._pending: Dict[str, Dict[str, Any]] = {}
        self.resend_count = 0
        # Flight recorder + metrics plane (repro_torch.obs, DESIGN.md §18).
        # Pass a ``TraceRecorder(thread_safe=True)``: the coordinator only
        # emits from its own thread, but a wired ChaosController emits
        # K_FAULT from the chaos scheduler thread.
        self.obs = obs
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        host_ids = [f"h{i:02d}" for i in range(cfg.n_hosts)]
        self._host_pos = {hid: i for i, hid in enumerate(host_ids)}
        if obs is not None:
            obs.time_fn = self.clock.time
            if self.chaos is not None and getattr(self.chaos, "obs", None) \
                    is None:
                self.chaos.obs = obs
        for hid in host_ids:
            self._spawn_host(hid)
        if self.chaos is not None:
            self.chaos.arm(self.hosts, self.clock)
        # Columnar substrate: the same incrementally-maintained columns the
        # simulator writes through, here fed from live heartbeats/progress
        # messages. Single-writer: only the coordinator thread touches the
        # arrays (heartbeats land in ``self.heartbeats`` under a lock and
        # are folded into ``node_hb`` at snapshot build).
        self.arr: Optional[ArraySnapshot] = None
        self.speculator: Optional[BinocularSpeculator] = None
        self._ref_spec: Optional[BinocularSpeculator] = None
        if cfg.recovery == "bino":
            bc = BinoConfig(glance=cfg.glance(),
                            collective=CollectiveConfig(check_period=0.2))
            if cfg.speculator_factory is not None:
                self.speculator = cfg.speculator_factory(host_ids)
            else:
                self.speculator = BinocularSpeculator(
                    host_ids, bc, assess_backend=cfg.assess_backend)
            if cfg.assess_columnar:
                self.arr = ArraySnapshot(host_ids, n_containers=2)
                # Runtime progress is message-driven: between reports an
                # attempt's observed work is frozen, so the accrual term
                # (now - last_sync)·node_speed must vanish. This keeps
                # progress_at() ≡ the reference AttemptView.progress.
                self.arr.node_speed[:] = 0.0
            if cfg.verify_columnar and cfg.assess_columnar \
                    and not getattr(self.speculator, "learned", False):
                # Learned policies are never shadowed by the reference
                # speculator: the differential gate checks columnar ≡
                # object-walk *of the same policy*, and a PredictorPolicy
                # has no object-walk twin (DESIGN.md §20).
                # The shadow walks objects (its snapshots carry no
                # arrays); numpy is the reference's default backend.
                self._ref_spec = BinocularSpeculator(host_ids, bc,
                                                     assess_backend="numpy")
            if obs is not None:
                # Policy-side decision records (K_LATE / K_GLANCE_* /
                # K_THRESH / K_RAMP). Never wired into ``_ref_spec`` —
                # the differential shadow would double-emit. Factory
                # policies may lack glance/collective sub-assessors.
                self.speculator.obs = obs
                glance = getattr(self.speculator, "glance", None)
                if glance is not None:
                    glance.obs = obs
                coll = getattr(self.speculator, "collective", None)
                if coll is not None:
                    coll.obs = obs
        self.reports: List[StepReport] = []

    # ------------------------------------------------------------------
    def _spawn_host(self, hid: str) -> None:
        out = self.queue
        hb: Callable[[str, float], None] = self._on_heartbeat
        if self.chaos is not None:
            out = self.chaos.wrap_out(hid, self.queue)
            hb = self.chaos.wrap_heartbeat(hid, self._on_heartbeat)
        h = HostDaemon(
            hid, grad_fn=self.grad_fn, batch_fn=self.batch_fn,
            out_queue=out, heartbeat=hb,
            heartbeat_period=self.cfg.heartbeat_period,
            compute_delay=self.cfg.compute_delay, clock=self.clock)
        self.hosts[hid] = h
        self.heartbeats[hid] = self.clock.time()
        h.start()

    def _on_heartbeat(self, host_id: str, now: float) -> None:
        with self._hb_lock:
            # Monotonic guard: a chaos-delayed heartbeat arrives late with
            # its ORIGINAL timestamp — never let it rewind liveness.
            if now > self.heartbeats.get(host_id, 0.0):
                self.heartbeats[host_id] = now

    def live_hosts(self) -> List[str]:
        return [h for h in self.hosts if h not in self.dead_hosts]

    def _quorum(self) -> int:
        return max(1, math.ceil(self.cfg.quorum_frac * len(self.hosts)))

    def shutdown(self) -> None:
        if self.chaos is not None:
            self.chaos.stop()
        for h in self.hosts.values():
            h.shutdown()
        # Release any FakeClock sleepers, then reap the daemons — exiting
        # the interpreter while a worker is inside an XLA call aborts the
        # process, so teardown must be deterministic.
        close = getattr(self.clock, "close", None)
        if close is not None:
            close()
        for h in self.hosts.values():
            h.join(timeout=2.0)

    # ------------------------------------------------------------------
    # One training step
    # ------------------------------------------------------------------
    def run_step(self, step: int) -> StepReport:
        t0 = self.clock.time()
        recoveries: List[str] = []
        restarts = 0
        wedges = 0
        mb_executed = 0
        while True:
            ok, mb_tried, metrics, status = self._try_step(step, recoveries)
            mb_executed += mb_tried  # discarded work still counts as waste
            if ok:
                break
            if status == "restart":
                restarts += 1
                self.metrics.counter("restarts").inc()
                continue
            # Wedged: graceful degradation instead of gang abort — the
            # step rolls back to its in-memory commit point (state only
            # mutates on success) and resumes on the surviving quorum.
            wedges += 1
            self.metrics.counter("wedges").inc()
            if wedges > self.cfg.step_retry_limit:
                raise StepWedged(step, status)
            self._declare_silent_dead(recoveries)
            if self.obs is not None:
                # step-level in-memory rollback (a = -1: not host-scoped)
                self.obs.emit(K_ROLLBACK, a=-1, b=wedges,
                              obj=f"step{step}")
            recoveries.append(
                f"step {step}: {status} -> rollback resume "
                f"#{wedges} on {len(self.live_hosts())} hosts")
        report = StepReport(
            step=step, wall_s=self.clock.time() - t0,
            mb_executed=mb_executed,
            mb_needed=self.n_shards * self.cfg.microbatches_per_shard,
            recoveries=recoveries, restarts=restarts, metrics=metrics,
            wedges=wedges)
        self.metrics.histogram("step_wall").observe(report.wall_s)
        self.metrics.counter("mb_executed").inc(mb_executed)
        self.reports.append(report)
        return report

    # -- step internals --------------------------------------------------
    def _assign(self, step, tasks, attempts, task_id: str, shard: int,
                host_id: str, mb_start: int, *, speculative: bool,
                rollback: bool, data_state: DataState) -> None:
        aid = f"{task_id}_a{next(self._aid)}"
        M = self.cfg.microbatches_per_shard
        now = self.clock.time()
        rec = _AttemptRec(aid, task_id, host_id, now, mb_start,
                          M - mb_start, speculative=speculative,
                          rollback=rollback, last_seen=now)
        attempts[aid] = rec
        t = tasks[task_id]
        seq = len(t["attempts"])
        t["attempts"].append(rec)
        if self.obs is not None:
            self.obs.emit(
                K_ATT_START, a=self._host_pos[host_id],
                b=(1 if speculative else 0) | (2 if rollback else 0),
                obj=aid)
        if self.arr is not None:
            rec.row = self.arr.add_attempt(
                rec, aid, task_id, t["order"], seq, t["job_idx"],
                self.arr.node_index[host_id], TaskKind.MAP,
                speculative, now, work_done=0.0, work_total=max(1, M - mb_start),
                n_deps=1,
                task_state=(TaskState.COMPLETED if t["done"]
                            else TaskState.RUNNING))
        # Parameter distribution is an out-of-band bulk transfer (a
        # parameter-store read), not part of the faulted message plane.
        self.hosts[host_id].set_params(self.state["params"])
        item = WorkItem(
            step=step, task_id=task_id, shard_id=shard,
            mb_start=mb_start, mb_end=M, data_state=data_state,
            attempt_id=aid, speculative=speculative)
        self._pending[aid] = {
            "item": item, "host": host_id, "tries": 0,
            "next_at": now + self.cfg.ack_timeout}
        self._deliver(host_id, item)

    def _deliver(self, host_id: str, item: WorkItem) -> None:
        host = self.hosts[host_id]
        if self.chaos is not None:
            self.chaos.deliver_assign(host, item)
        else:
            host.assign(item)

    def _pump_retries(self, step, now, tasks, attempts, grads, shard_states,
                      recoveries) -> None:
        """At-least-once assign delivery: redeliver unacked work items
        with jittered exponential backoff; on exhaustion fail the attempt
        over to another host (DESIGN.md §16.5)."""
        cfg = self.cfg
        for aid, p in list(self._pending.items()):
            if now < p["next_at"]:
                continue
            rec = attempts.get(aid)
            if rec is None or rec.state != AttemptState.RUNNING:
                self._pending.pop(aid, None)
                continue
            if p["tries"] >= cfg.send_retries:
                self._pending.pop(aid, None)
                self._set_astate(rec, AttemptState.FAILED)
                recoveries.append(
                    f"{rec.task_id}: assign to {rec.host_id} undeliverable "
                    f"after {p['tries']} retries -> failover")
                self._relaunch(step, tasks, attempts, grads, shard_states,
                               rec.task_id, reason="assign-undeliverable",
                               recoveries=recoveries,
                               exclude_extra={rec.host_id})
                continue
            p["tries"] += 1
            self.resend_count += 1
            self.metrics.counter("resends").inc()
            backoff = min(cfg.backoff_cap,
                          cfg.backoff_base * (2.0 ** p["tries"]))
            backoff *= 1.0 + cfg.backoff_jitter * self._rng.random()
            p["next_at"] = now + cfg.ack_timeout + backoff
            self._deliver(p["host"], p["item"])

    def _set_astate(self, rec: _AttemptRec, state: AttemptState) -> None:
        rec.state = state
        if state != AttemptState.RUNNING:
            rec.end = self.clock.time()
            if self.obs is not None:
                code = (END_COMPLETED if state == AttemptState.COMPLETED
                        else END_KILLED if state == AttemptState.KILLED
                        else END_FAILED)
                self.obs.emit(
                    K_ATT_END, a=self._host_pos[rec.host_id], b=code,
                    f0=rec.start, f1=float(rec.mb_done),
                    f2=1.0 if rec.speculative else 0.0,
                    obj=rec.attempt_id)
        if self.arr is not None and rec.row >= 0:
            self.arr.set_attempt_state(rec.row, state)

    def _mark_task_done(self, tasks, tid: str) -> None:
        t = tasks[tid]
        t["done"] = True
        if self.arr is not None:
            self.arr.set_task_state(
                [a.row for a in t["attempts"] if a.row >= 0],
                TaskState.COMPLETED)

    def _pick_host(self, tasks, exclude: Set[str],
                   prefer: Sequence[str] = ()) -> Optional[str]:
        """Least-loaded live host, placement hints first."""
        busy: Dict[str, int] = {h: 0 for h in self.live_hosts()}
        for t in tasks.values():
            for a in t["attempts"]:
                if a.state == AttemptState.RUNNING and a.host_id in busy:
                    busy[a.host_id] += 1
        for h in prefer:
            if h in busy and h not in exclude:
                return h
        cands = [h for h in busy if h not in exclude]
        if not cands:
            cands = list(busy)  # nothing else: double up anywhere alive
        if not cands:
            return None
        return min(cands, key=lambda h: (busy[h], h))

    def _try_step(self, step: int, recoveries: List[str]
                  ) -> Tuple[bool, int, Dict[str, float], str]:
        M = self.cfg.microbatches_per_shard
        grads: Dict[Tuple[int, int], Any] = {}
        metric_acc: Dict[str, float] = {}
        mb_executed = 0
        tasks: Dict[str, Dict[str, Any]] = {}
        attempts: Dict[str, _AttemptRec] = {}
        shard_states: Dict[int, DataState] = {}
        self._pending.clear()

        live = self.live_hosts()
        if not live:
            raise RuntimeError("no live hosts remain")
        if len(live) < self._quorum():
            return False, 0, {}, "quorum lost"
        job_id = f"step{step}"
        job_idx = -1
        if self.arr is not None:
            job_idx = self.arr.job_started(job_id)
        now0 = self.clock.time()
        for s in range(self.n_shards):
            tid = f"s{step}_grad{s:03d}"
            tasks[tid] = {"shard": s, "attempts": [], "done": False,
                          "order": next(self._task_order),
                          "job_idx": job_idx,
                          "t0": now0, "last_grad": now0, "repairs": 0,
                          "next_repair": now0}
            shard_states[s] = self.datastates[s]
            if self.arr is not None:
                self.arr.task_created(job_idx)

        # initial placement: shards round-robin over live hosts
        for s in range(self.n_shards):
            tid = f"s{step}_grad{s:03d}"
            host = live[s % len(live)]
            self._assign(step, tasks, attempts, tid, s, host, 0,
                         speculative=False, rollback=False,
                         data_state=shard_states[s])

        last_tick = 0.0
        last_grad = self.clock.time()
        auto = max(60.0, 30 * self.cfg.restart_timeout)
        deadline = self.clock.time() + (self.cfg.step_deadline or auto)
        while len(grads) < self.n_shards * M:
            now = self.clock.time()
            if now > deadline:
                self._abort_inflight(step, attempts)
                return False, mb_executed, {}, "deadline exceeded"
            if len(self.live_hosts()) < self._quorum():
                self._abort_inflight(step, attempts)
                return False, mb_executed, {}, "quorum lost"
            try:
                msg = self.queue.get(timeout=0.02)
            except queue.Empty:
                msg = None
            if isinstance(msg, GradMessage):
                if msg.step != step:
                    continue  # stale stream from a previous step's loser
                key = (msg.shard_id, msg.mb_index)
                mb_executed += 1
                rec = attempts.get(msg.attempt_id)
                if rec is not None:
                    rec.last_seen = self.clock.time()
                if key not in grads:  # exactly-once: first writer wins
                    grads[key] = msg.grads
                    for k, v in msg.metrics.items():
                        metric_acc[k] = metric_acc.get(k, 0.0) + v
                    tid = f"s{step}_grad{msg.shard_id:03d}"
                    t = tasks.get(tid)
                    if t is not None:
                        t["last_grad"] = self.clock.time()
                        last_grad = t["last_grad"]
                        # Coverage decides completion — never an attempt's
                        # own done-claim, which can vanish in transit.
                        if not t["done"]:
                            have = sum(1 for (s, _m) in grads
                                       if s == msg.shard_id)
                            if have >= M:
                                self._mark_task_done(tasks, tid)
            elif isinstance(msg, ProgressMessage):
                if msg.step != step:
                    continue
                rec = attempts.get(msg.attempt_id)
                if rec is not None and rec.state == AttemptState.RUNNING:
                    # max(): chaos can reorder adjacent reports
                    rec.mb_done = max(rec.mb_done, msg.mb_done)
                    rec.last_seen = self.clock.time()
                    if self.arr is not None and rec.row >= 0:
                        self.arr.sync_row(rec.row, float(rec.mb_done),
                                          rec.last_seen)
                    if msg.done:
                        self._set_astate(rec, AttemptState.COMPLETED)
                    # progress log: offset fraction + resumable data state
                    log = ProgressLog(
                        task_id=msg.task_id, node_id=msg.host_id,
                        offset=msg.mb_done / max(msg.mb_total, 1),
                        handle=msg.data_state)
                    if self.speculator is not None:
                        self.speculator.record_progress_log(log)
                    if self._ref_spec is not None:
                        self._ref_spec.record_progress_log(log)
            elif isinstance(msg, AckMessage):
                self._pending.pop(msg.attempt_id, None)

            now = self.clock.time()
            self._pump_retries(step, now, tasks, attempts, grads,
                               shard_states, recoveries)
            if now - last_tick >= self.cfg.spec_interval:
                last_tick = now
                if self.speculator is not None:
                    self._bino_tick(step, tasks, attempts, grads,
                                    shard_states, recoveries)
                else:
                    aborted = self._restart_tick(tasks, attempts,
                                                 recoveries, last_grad)
                    if aborted:
                        self._finish_job(step)
                        return False, mb_executed, {}, "restart"

        # ---- reduce: deterministic ordered sum + optimizer apply -------
        # Each leaf's float32 sum over the sorted (shard, microbatch) keys,
        # from the first key on, where the gradients lie (the card).
        ordered = [grads[k] for k in sorted(grads)]
        denom = float(self.n_shards * M)
        total = {}
        for name in ordered[0]:
            acc = ordered[0][name].float()
            for g in ordered[1:]:
                acc = acc + g[name].float()
            total[name] = acc / denom
        self.state = self.apply_fn(self.state, total)
        for s in range(self.n_shards):
            self.datastates[s] = self.datastates[s].advance(M)
        for h in self.live_hosts():
            self.hosts[h].set_params(self.state["params"])
        metrics = {k: v / denom for k, v in metric_acc.items()}
        self._finish_job(step)
        return True, mb_executed, metrics, "ok"

    def _finish_job(self, step: int) -> None:
        job_id = f"step{step}"
        if self.arr is not None:
            self.arr.job_finished(job_id)
        if self.speculator is not None:
            self.speculator.job_done(job_id)
        if self._ref_spec is not None:
            self._ref_spec.job_done(job_id)

    def _abort_inflight(self, step: int, attempts) -> None:
        """Cancel running attempts, drop pending sends and drain the inbox
        — the cleanup edge of an in-memory step rollback."""
        for a in attempts.values():
            if a.state == AttemptState.RUNNING:
                self._set_astate(a, AttemptState.KILLED)
                if a.host_id not in self.dead_hosts:
                    self.hosts[a.host_id].cancel(a.attempt_id)
        self._pending.clear()
        self._drain()
        self._finish_job(step)

    def _declare_silent_dead(self, recoveries: List[str]) -> None:
        """Graceful degradation on a wedged step: hosts silent beyond the
        gang threshold are declared dead before the rollback resume, so
        the retry places work only on responsive survivors."""
        now = self.clock.time()
        with self._hb_lock:
            hb = dict(self.heartbeats)
        thresh = max(self.cfg.restart_timeout,
                     8 * self.cfg.heartbeat_period)
        for hid in self.live_hosts():
            if now - hb.get(hid, 0.0) > thresh:
                self.dead_hosts.add(hid)
                if self.obs is not None:
                    self.obs.emit(K_DETECT, a=self._host_pos[hid], b=0,
                                  obj="silent-at-rollback")
                self.metrics.counter("expiry_declares").inc()
                recoveries.append(
                    f"host {hid} silent {now - hb.get(hid, 0.0):.2f}s "
                    "at rollback -> declared dead")

    # -- bino recovery ----------------------------------------------------
    def _snapshot(self, step, tasks, attempts, grads) -> ClusterSnapshot:
        now = self.clock.time()
        with self._hb_lock:
            hb = dict(self.heartbeats)
        nodes = {}
        running_by_host: Dict[str, int] = {}
        for a in attempts.values():
            if a.state == AttemptState.RUNNING:
                running_by_host[a.host_id] = \
                    running_by_host.get(a.host_id, 0) + 1
        for hid in self.hosts:
            nodes[hid] = NodeView(
                node_id=hid, last_heartbeat=hb.get(hid, 0.0),
                total_containers=2,
                free_containers=max(0, 2 - running_by_host.get(hid, 0)),
                marked_failed=hid in self.dead_hosts)
        if self.arr is not None:
            # Fold the live heartbeat/occupancy state into the node
            # columns — this is the snapshot point: the columnar and
            # reference views of the cluster are frozen together.
            for hid, i in self.arr.node_index.items():
                nv = nodes[hid]
                self.arr.node_hb[i] = nv.last_heartbeat
                self.arr.node_free[i] = nv.free_containers
                self.arr.node_marked[i] = nv.marked_failed
        tviews: Dict[str, TaskView] = {}
        job_id = f"step{step}"
        M = self.cfg.microbatches_per_shard
        for tid, t in tasks.items():
            shard = t["shard"]
            avs = []
            for a in t["attempts"]:
                avs.append(AttemptView(
                    attempt_id=a.attempt_id, task_id=tid,
                    node_id=a.host_id, state=a.state, start_time=a.start,
                    progress=a.mb_done / max(a.mb_total, 1),
                    is_speculative=a.speculative,
                    is_rollback=a.rollback))
            have = sum(1 for (s, _m) in grads if s == shard)
            tviews[tid] = TaskView(
                task_id=tid, job_id=job_id, kind=TaskKind.MAP,
                state=(TaskState.COMPLETED if have >= M
                       else TaskState.RUNNING),
                attempts=avs, output_available=have >= M,
                output_nodes=("coord",))
        return ClusterSnapshot(now=now, nodes=nodes, tasks=tviews,
                               arrays=self.arr)

    def _assess(self, snap: ClusterSnapshot) -> List[Any]:
        """Policy tick; with ``verify_columnar`` the per-object reference
        engine runs on the same frozen snapshot and must agree action for
        action — the sim-vs-runtime differential gate (DESIGN.md §16.6)."""
        actions = self.speculator.assess(snap)
        if self._ref_spec is not None and snap.arrays is not None:
            ref = self._ref_spec.assess(
                dataclasses.replace(snap, arrays=None))
            if _action_sig(ref) != _action_sig(actions):
                raise AssertionError(
                    "columnar/reference divergence at now="
                    f"{snap.now:.3f}:\n  columnar={_action_sig(actions)}"
                    f"\n  reference={_action_sig(ref)}")
        return actions

    def _bino_tick(self, step, tasks, attempts, grads, shard_states,
                   recoveries) -> None:
        snap = self._snapshot(step, tasks, attempts, grads)
        actions = self._assess(snap)
        for act in actions:
            if isinstance(act, MarkNodeFailed):
                if act.node_id in self.dead_hosts:
                    continue
                self.dead_hosts.add(act.node_id)
                if self.obs is not None:
                    self.obs.emit(K_DETECT, a=self._host_pos[act.node_id],
                                  b=1, obj=act.reason)
                self.metrics.counter("detections").inc()
                recoveries.append(f"host {act.node_id} declared failed "
                                  f"({act.reason})")
                # fail its running attempts; reassignment happens via the
                # straggler path below or immediately here
                for a in list(attempts.values()):
                    if a.host_id == act.node_id \
                            and a.state == AttemptState.RUNNING:
                        self._set_astate(a, AttemptState.FAILED)
                        self._pending.pop(a.attempt_id, None)
                        self._relaunch(step, tasks, attempts, grads,
                                       shard_states, a.task_id,
                                       reason="failure",
                                       recoveries=recoveries)
            elif isinstance(act, SpeculateTask):
                tid = act.task_id
                if tid not in tasks or tasks[tid]["done"]:
                    continue
                running = [a for a in tasks[tid]["attempts"]
                           if a.state == AttemptState.RUNNING]
                if any(a.speculative for a in running) or len(running) >= 2:
                    continue
                self._relaunch(step, tasks, attempts, grads, shard_states,
                               tid, reason=act.reason, recoveries=recoveries,
                               speculative=bool(running),
                               prefer=act.placement_hint)
            elif isinstance(act, KillAttempt):
                a = attempts.get(act.attempt_id)
                if a is not None and a.state == AttemptState.RUNNING:
                    self._set_astate(a, AttemptState.KILLED)
                    self._pending.pop(a.attempt_id, None)
                    if a.host_id not in self.dead_hosts:
                        self.hosts[a.host_id].cancel(a.attempt_id)
        now = self.clock.time()
        # Exactly-once hole repair (DESIGN.md §16.5): results can vanish
        # in transit — an attempt may even "finish" inside a drop window,
        # leaving its task incomplete forever. Any incomplete task with no
        # freshly-reporting attempt is resumed from the first missing
        # microbatch, under per-task exponential backoff so a persistent
        # outage doesn't spray attempts.
        for tid, t in tasks.items():
            if t["done"]:
                continue
            running = [a for a in t["attempts"]
                       if a.state == AttemptState.RUNNING]
            fresh = [a for a in running
                     if now - a.last_seen < self.cfg.repair_timeout]
            # A running attempt that never streamed anything may just be
            # warming up (first-call jit compile): only a stream that
            # STOPPED (grads seen this try, then silence) or a task with
            # no attempts left marks a hole.
            started = t["last_grad"] > t["t0"]
            if fresh or (running and not started) \
                    or now < t["next_repair"] \
                    or now - t["last_grad"] < self.cfg.repair_timeout:
                continue
            t["repairs"] += 1
            pause = self.cfg.repair_timeout * (2.0 ** min(t["repairs"], 5))
            t["next_repair"] = now + pause * \
                (1.0 + self.cfg.backoff_jitter * self._rng.random())
            self._relaunch(step, tasks, attempts, grads, shard_states,
                           tid, reason="hole-repair", recoveries=recoveries)
        # Tail-straggler fallback (beyond-paper; DESIGN.md §10): once most
        # map tasks have drained, Eq. 1 loses its comparison population (the
        # paper's own small-job blind spot, §II.D.2) — so the coordinator
        # adds a LATE-style estimated-remaining-time check against the
        # completed population and shadow-executes the laggards.
        completed = [a for a in attempts.values()
                     if a.state == AttemptState.COMPLETED]
        running = [t for t in tasks.values() if not t["done"]]
        if completed and running and \
                len(running) <= max(1, len(tasks) // 4):
            durations = sorted((a.end - a.start) for a in completed)
            median = durations[len(durations) // 2]
            for t in tasks.values():
                if t["done"]:
                    continue
                live = [a for a in t["attempts"]
                        if a.state == AttemptState.RUNNING]
                if not live or any(a.speculative for a in live):
                    continue
                a = max(live, key=lambda a: a.mb_done)
                frac = a.mb_done / max(a.mb_total, 1)
                rate = frac / max(now - a.start, 1e-6)
                est_remaining = (1.0 - frac) / max(rate, 1e-6)
                if est_remaining > max(1.5 * median,
                                       4 * self.cfg.spec_interval):
                    tid = [k for k, v in tasks.items() if v is t][0]
                    self._relaunch(step, tasks, attempts, grads,
                                   shard_states, tid,
                                   reason="tail-straggler",
                                   recoveries=recoveries, speculative=True)

    def _relaunch(self, step, tasks, attempts, grads, shard_states, tid,
                  *, reason: str, recoveries: List[str],
                  speculative: bool = False,
                  prefer: Sequence[str] = (),
                  exclude_extra: Optional[Set[str]] = None) -> None:
        shard = tasks[tid]["shard"]
        M = self.cfg.microbatches_per_shard
        # Rollback: resume past every microbatch already streamed (the
        # consumer-side MOF survives the producer) — exactly-once keeps
        # racing duplicates harmless anyway.
        have = sorted(m for (s, m) in grads if s == shard)
        resume = 0
        for m in have:
            if m == resume:
                resume += 1
            else:
                break
        if resume >= M:
            return
        exclude = {a.host_id for a in tasks[tid]["attempts"]
                   if a.state == AttemptState.RUNNING} | self.dead_hosts
        if exclude_extra:
            exclude |= exclude_extra
        host = self._pick_host(tasks, exclude, prefer)
        if host is None:
            return
        st = self.datastates[shard]
        for _ in range(resume):
            st = st.advance()
        if self.obs is not None and resume > 0:
            # rollback resume: only the missing microbatches re-execute
            self.obs.emit(K_ROLLBACK, a=self._host_pos[host],
                          f0=resume / M, obj=tid)
        self.metrics.counter("recoveries").inc()
        self._assign(step, tasks, attempts, tid, shard, host, resume,
                     speculative=speculative,
                     rollback=resume > 0, data_state=st)
        recoveries.append(
            f"{tid}: {reason} -> {'spec' if speculative else 'relaunch'} "
            f"on {host} from mb {resume}")

    # -- gang-restart baseline ---------------------------------------------
    def _restart_tick(self, tasks, attempts, recoveries,
                      last_grad: float) -> bool:
        now = self.clock.time()
        with self._hb_lock:
            hb = dict(self.heartbeats)
        silent = [hid for hid in self.live_hosts()
                  if now - hb.get(hid, 0.0) > self.cfg.restart_timeout]
        # Progress watchdog: a dropped result stream looks like a wedged
        # step with perfectly healthy heartbeats — the gang baseline can
        # only ever re-run the whole step.
        stalled = (now - last_grad > self.cfg.restart_timeout
                   and any(not t["done"] for t in tasks.values()))
        if not silent and not stalled:
            return False
        for hid in silent:
            self.dead_hosts.add(hid)
            if self.obs is not None:
                self.obs.emit(K_DETECT, a=self._host_pos[hid], b=0,
                              obj="gang-timeout")
            self.metrics.counter("expiry_declares").inc()
            recoveries.append(
                f"host {hid} timed out ({self.cfg.restart_timeout}s) "
                "-> gang restart of step")
        if stalled and not silent:
            recoveries.append(
                f"gradient stream stalled {self.cfg.restart_timeout}s "
                "-> gang restart of step")
        # abort: cancel everything, discard partials
        for a in attempts.values():
            if a.state == AttemptState.RUNNING:
                self._set_astate(a, AttemptState.KILLED)
                if a.host_id not in self.dead_hosts:
                    self.hosts[a.host_id].cancel(a.attempt_id)
        self._pending.clear()
        self._drain()
        return True

    def _drain(self) -> None:
        try:
            while True:
                self.queue.get_nowait()
        except queue.Empty:
            pass


def _action_sig(actions) -> List[Tuple]:
    """Canonical, comparable form of a policy action list."""
    out = []
    for a in actions:
        d = dataclasses.asdict(a)
        out.append((type(a).__name__,
                    tuple(sorted((k, str(v)) for k, v in d.items()))))
    return out


def rec_step(task_id: str) -> int:
    return int(task_id.split("_")[0][1:])
