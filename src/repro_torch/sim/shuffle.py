"""Shuffle substrate: per-reduce fetch state, MOF registry, and the two
fetch-candidate selection engines (DESIGN.md §12).

The seed simulator rediscovered work by rescanning: every free fetch slot
re-walked the reducer's full dependency list (O(n_maps) per slot), and
every map completion broadcast to every running reduce attempt. That poll
loop was ~2/3 of a 500-node run's wall time once the assessment path went
columnar. This module replaces it with an event-driven subsystem while
keeping the rescan path in-tree as the byte-exact reference:

- :class:`RescanShuffle` — the seed algorithm, verbatim: candidate list
  comprehension over ``task.deps`` per slot, completion broadcast over
  ``job.reduces × running_attempts``, MOF source by attribute scan.
- :class:`EventShuffle` — per-attempt indexed ready-deque (a min-heap of
  dependency indices, so slot filling pops the *lowest-index* ready
  producer in O(log n) — the same producer the reference scan would
  pick), fed by a per-producer subscriber registry (map completion
  notifies only attempts still wanting that partition), with MOF sources
  answered by :class:`MofRegistry` instead of attribute scans.
- :class:`BatchShuffle` — EventShuffle's selection logic over the
  engine's macro-event calendar lane (DESIGN.md §14): fetch completions
  and failure cycles are typed records in a
  :class:`~repro_torch.sim.engine.BatchQueue` instead of per-event heap
  entries, drained in bulk between heap events; timer cancellation is a
  token drop (stale records are discarded at apply time); the columnar
  ``sh_*``/``fetched`` write-through is deferred per drain and flushed
  as one bulk write before any heap event can read it; producer
  completions fan out with a budget gate that skips the (provably
  no-op) ``try_start`` of saturated attempts.

Equivalence contract: all engines drive the simulation through identical
event sequences — same fetches, same sources, same flow accounting, same
failure cycles, in the same order — so seeded runs emit byte-identical
action traces (``tests/test_shuffle.py`` enforces this, mirroring the
columnar gate of DESIGN.md §11.3).

Dependency status is a per-attempt ``int8`` column (one code per dep):
every dependency is in exactly one of WAITING / READY / FAIL_CYCLE /
INFLIGHT / FETCHED, and the live counts are written through to the
columnar snapshot (``sh_ready``/``sh_inflight``/``sh_fail``) so fetch-
health signals stay vectorized.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Set

import numpy as np

from repro_torch.core.rollback import ProgressLog
from repro_torch.core.speculator import BinocularSpeculator
from repro_torch.core.types import AttemptState, TaskState
from repro_torch.obs.trace import K_FETCH_FAIL
from repro_torch.sim.cluster import DISK_BW, NIC_BW

if TYPE_CHECKING:  # pragma: no cover - import cycle guard, typing only
    from repro_torch.sim.engine import EventHandle
    from repro_torch.sim.mapreduce import SimAttempt, SimTask, Simulation

# Dependency status codes. "Subscribed" states (the attempt still wants a
# completion notification for this producer) are exactly codes < INFLIGHT.
S_WAITING = 0      # producer not (re)completed yet
S_READY = 1        # producer completed; awaiting a free fetch slot
S_FAIL_CYCLE = 2   # burning a failed-fetch timeout cycle
S_INFLIGHT = 3     # transfer in progress
S_FETCHED = 4      # partition landed
_SUBSCRIBED_MAX = S_FAIL_CYCLE


@dataclasses.dataclass
class ShuffleProfile:
    """Work counters exposing the rescan-vs-event win (examples/cluster_sim
    prints these: fetch slots filled per unit of candidate-selection work)."""

    notifies: int = 0        # producer-completion notifications processed
    try_calls: int = 0       # try_start_fetches invocations
    slots_filled: int = 0    # fetch starts + failure cycles begun
    deps_scanned: int = 0    # rescan mode: dependency list entries walked
    heap_pops: int = 0       # event mode: ready-heap pops (incl. stale)
    lane_records: int = 0    # batch mode: calendar-lane records applied

    @property
    def selection_work(self) -> int:
        return self.deps_scanned + self.heap_pops

    def slots_per_kwork(self) -> float:
        """Fetch slots filled per 1000 candidate-selection steps."""
        return 1000.0 * self.slots_filled / max(1, self.selection_work)


class ShuffleState:
    """Per-reduce-attempt shuffle bookkeeping.

    One status code per dependency plus the handle/source maps keyed by
    producer task id. ``key`` is the canonical notification order:
    (task creation order, attempt index) — exactly the order the rescan
    broadcast visits attempts, so the event engine's subscriber fan-out
    stays trace-equivalent.
    """

    __slots__ = ("attempt", "status", "ready", "n_ready", "fetched",
                 "inflight", "fail_cycles", "fetch_srcs", "failed_cycles",
                 "key", "log", "log_pos", "parked")

    def __init__(self, attempt: "SimAttempt"):
        task = attempt.task
        self.attempt = attempt
        self.status = np.zeros(len(task.deps), dtype=np.int8)
        self.ready: List[int] = []          # min-heap of dependency indices
        self.n_ready = 0
        self.fetched: Set[str] = set()
        self.inflight: Dict[str, "EventHandle"] = {}
        self.fail_cycles: Dict[str, "EventHandle"] = {}
        self.fetch_srcs: Dict[str, str] = {}
        self.failed_cycles = 0              # abort counter (EXCEEDED_MAX)
        self.key = (task.order, len(task.attempts))
        # Batch mode: the job's producer-completion log (shared,
        # append-only; BatchShuffle._init_ready swaps in the job's real
        # list — under rescan/event this stays the immutable empty
        # sentinel and is never read) and the position up to which this
        # attempt has reconciled its WAITING→READY flips; ``parked``
        # mirrors membership in the engine's idle set so the steady
        # state skips the dict entirely.
        self.log: Sequence[int] = ()
        self.log_pos = 0
        self.parked = False

    def set_status(self, i: int, code: int) -> None:
        old = self.status[i]
        if old == code:
            return
        if old == S_READY:
            self.n_ready -= 1
        if code == S_READY:
            self.n_ready += 1
        self.status[i] = code


class MofRegistry:
    """Indexed map-output locations: producer → live source nodes, plus
    node → completed tasks listing it in ``output_nodes``.

    ``live[m]`` holds exactly the nodes where the old attribute scan would
    find the MOF (alive ∧ MOF on disk ∧ not marked failed): entries are
    added on map completion and dropped on node death / marked-failed /
    silent MOF loss — the node's own ``mofs`` dict is the reverse index,
    so drops are O(MOFs on that node), not O(all maps).

    ``placements`` mirrors ``output_nodes`` membership so node expiry can
    prune exactly the affected producers instead of sweeping every map of
    every active job.
    """

    def __init__(self):
        self.live: Dict[str, Set[str]] = {}
        self.placements: Dict[str, Dict["SimTask", None]] = {}
        # Nodes whose network link is cut (shared with the simulation's
        # ``_link_down`` set): their MOF copies are unreachable, so they
        # never enter ``live`` — mirroring the reference scan's
        # link-liveness check (DESIGN.md §15.5).
        self.down: Set[str] = set()

    def add(self, task: "SimTask", node_id: str) -> None:
        if node_id not in self.down:
            self.live.setdefault(task.task_id, set()).add(node_id)
        self.placements.setdefault(node_id, {})[task] = None

    def drop_node_sources(self, node) -> None:
        """Node died or was marked failed: its MOF copies stop being
        fetchable. Must run before ``node.mofs`` is cleared."""
        for task_id in node.mofs:
            s = self.live.get(task_id)
            if s is not None:
                s.discard(node.node_id)

    def drop_producer(self, task_id: str) -> None:
        self.live.pop(task_id, None)

    def pick(self, task: "SimTask") -> Optional[str]:
        """First live source in ``output_nodes`` order — the same copy the
        reference attribute scan returns."""
        live = self.live.get(task.task_id)
        if not live:
            return None
        for nid in task.output_nodes:
            if nid in live:
                return nid
        return None

    def take_placed(self, node_id: str) -> List["SimTask"]:
        """Producers with ``node_id`` in their ``output_nodes``, in task
        creation order (= active-job submission order → map index order,
        the reference sweep order). Callers re-register tasks they skip
        via :meth:`keep_placed`."""
        tasks = self.placements.pop(node_id, None)
        if not tasks:
            return []
        return sorted(tasks, key=lambda t: t.order)

    def keep_placed(self, node_id: str, task: "SimTask") -> None:
        self.placements.setdefault(node_id, {})[task] = None

    def forget_task(self, task: "SimTask") -> None:
        self.live.pop(task.task_id, None)
        for nid in task.output_nodes:
            d = self.placements.get(nid)
            if d is not None:
                d.pop(task, None)


class ShuffleEngine:
    """Mode-independent fetch mechanics: flow accounting, transfer and
    failure-cycle timers, completion/failure handling, teardown. The two
    subclasses differ only in *candidate selection* (how free slots find
    ready producers) and *notification* (who hears about a completion)."""

    mode = "base"

    def __init__(self, sim: "Simulation"):
        self.sim = sim
        self.registry = MofRegistry()
        self.registry.down = sim._link_down
        self.profile = ShuffleProfile()
        # Pluggable network model (DESIGN.md §15): every rate decision
        # and all flow accounting go through it.
        self._net = sim.cluster.net

    # -- attempt lifecycle ------------------------------------------------
    def attach(self, a: "SimAttempt") -> ShuffleState:
        ss = ShuffleState(a)
        a.shuffle = ss
        self._init_ready(a, ss)
        self._arr_sh(a, ss)
        return ss

    def detach(self, a: "SimAttempt") -> None:
        """Attempt ended: cancel transfers and timers, release flows,
        drop subscriptions."""
        ss = a.shuffle
        if ss is None:
            return
        for m, h in list(ss.inflight.items()):
            self._cancel(h)
            self._end_flow(a, ss, m, ss.fetch_srcs.get(m))
        for h in ss.fail_cycles.values():
            self._cancel(h)
        ss.inflight.clear()
        ss.fail_cycles.clear()
        self._drop_subscriptions(ss)
        ss.ready = []
        ss.n_ready = 0
        self._arr_sh(a, ss)

    def on_job_done(self, job) -> None:
        for t in job.maps:
            self.registry.forget_task(t)
            self._drop_producer_subs(t.task_id)

    # -- producer-side events --------------------------------------------
    def on_producer_completed(self, task: "SimTask", node_id: str) -> None:
        self.registry.add(task, node_id)
        self.profile.notifies += 1
        self._notify(task)

    def abort_fetch(self, a: "SimAttempt", m: str) -> None:
        """An in-flight transfer was invalidated (source died / MOF lost):
        cancel it and return the dependency to the candidate pool. The
        caller decides whether to retry immediately (``try_start``)."""
        ss = a.shuffle
        h = ss.inflight.get(m)
        if h is not None:
            self._cancel(h)
        self._end_flow(a, ss, m, ss.fetch_srcs.get(m))
        self._requeue(ss, a.task.dep_pos[m], m)
        self._arr_sh(a, ss)

    def mark_stalled(self, a: "SimAttempt") -> None:
        """The caller aborted transfers WITHOUT an immediate retry (a
        crashed host's own fetches stall silently), so the attempt sits
        with free budget and ready producers until the next completion in
        its job re-kicks it. The rescan broadcast reaches such attempts
        for free; the event engine must track them explicitly — this is
        the one place the "budget exhausted or ready-queue empty" steady
        state is deliberately broken."""

    def someone_still_needs(self, prod: "SimTask") -> bool:
        for r in prod.job.reduces:
            if r.state == TaskState.COMPLETED:
                continue
            for a in r.running_attempts():
                if prod.task_id not in a.shuffle.fetched:
                    return True
            if not r.running_attempts():
                return True  # a future attempt will need everything
        return False

    # -- shared fetch mechanics ------------------------------------------
    def _launch_fetch(self, a: "SimAttempt", ss: ShuffleState, m: str,
                      prod: "SimTask", src: str) -> None:
        sim = self.sim
        size = prod.job.spec.partition_bytes()
        rate = self._net.open_flow(src, a.node_id)
        ss.fetch_srcs[m] = src
        ss.inflight[m] = sim.engine.after(
            max(size / rate, 1e-3), self._fetch_done, a, m, src)
        self.profile.slots_filled += 1

    def _launch_fail_cycle(self, a: "SimAttempt", ss: ShuffleState,
                           m: str) -> None:
        # MOF is supposed to exist but no live copy: failure cycle.
        ss.fail_cycles[m] = self.sim.engine.after(
            self.sim.params.fetch_cycle, self._fetch_failed, a, m)
        self.profile.slots_filled += 1

    def _end_flow(self, a: "SimAttempt", ss: ShuffleState, m: str,
                  src: Optional[str]) -> None:
        if ss.inflight.pop(m, None) is not None and src is not None:
            self._net.close_flow(src, a.node_id)
        ss.fetch_srcs.pop(m, None)

    def _fetch_done(self, a: "SimAttempt", m: str, src: str) -> None:
        ss = a.shuffle
        self._end_flow(a, ss, m, src)
        if a.state != AttemptState.RUNNING:
            return
        ss.fetched.add(m)
        ss.set_status(a.task.dep_pos[m], S_FETCHED)
        sim = self.sim
        if a.row >= 0:
            sim.arrays.fetched[a.row] = len(ss.fetched)
            self._arr_sh(a, ss)
        if isinstance(sim.speculator, BinocularSpeculator):
            sim.speculator.note_fetch_ok(m)
        if len(ss.fetched) == len(a.task.deps):
            sim._start_compute(a)
        else:
            self.try_start(a)

    def _fetch_failed(self, a: "SimAttempt", m: str) -> None:
        ss = a.shuffle
        ss.fail_cycles.pop(m, None)
        if a.state != AttemptState.RUNNING:
            return
        ss.failed_cycles += 1
        sim = self.sim
        if sim.obs is not None:
            sim.obs.emit(K_FETCH_FAIL, a=sim.cluster._node_pos[a.node_id],
                         b=ss.failed_cycles, obj=m)
        # AM-side report (quorum bookkeeping may re-run the producer).
        sim._report_fetch_failure(a, m)
        prod = sim._task(m)
        i = a.task.dep_pos[m]
        if prod is not None and prod.state == TaskState.COMPLETED:
            self._requeue(ss, i, m)
        else:
            ss.set_status(i, S_WAITING)  # producer re-running; await notify
        self._arr_sh(a, ss)
        # Shuffle self-abort: the reduce attempt declares itself failed and
        # a fresh attempt re-shuffles — into the same missing MOF.
        if ss.failed_cycles >= sim.params.reduce_abort_cycles:
            sim._attempt_failed(a, reason="shuffle-exceeded-failures")
            return
        # retry (or go back to waiting if the producer restarted)
        self.try_start(a)

    # -- columnar write-through ------------------------------------------
    def _arr_sh(self, a: "SimAttempt", ss: ShuffleState) -> None:
        if a.row >= 0:
            arr = self.sim.arrays
            arr.sh_ready[a.row] = ss.n_ready
            arr.sh_inflight[a.row] = len(ss.inflight)
            arr.sh_fail[a.row] = len(ss.fail_cycles)

    # -- consistency (tests / verify_arrays) ------------------------------
    def verify_state(self, a: "SimAttempt") -> None:
        """Every dependency in exactly one status, and each status bucket
        in sync with its side structure."""
        ss = a.shuffle
        deps = a.task.deps
        counts = np.bincount(ss.status, minlength=5)
        assert int(counts.sum()) == len(deps)
        assert int(counts[S_FETCHED]) == len(ss.fetched)
        assert int(counts[S_INFLIGHT]) == len(ss.inflight)
        assert int(counts[S_FAIL_CYCLE]) == len(ss.fail_cycles)
        assert int(counts[S_READY]) == ss.n_ready
        assert ss.fetched == {deps[i] for i in
                              np.flatnonzero(ss.status == S_FETCHED)}
        assert set(ss.inflight) == {deps[i] for i in
                                    np.flatnonzero(ss.status == S_INFLIGHT)}
        assert set(ss.fail_cycles) == {
            deps[i] for i in np.flatnonzero(ss.status == S_FAIL_CYCLE)}
        assert set(ss.inflight) == set(ss.fetch_srcs)

    # -- mode hooks -------------------------------------------------------
    @staticmethod
    def _cancel(h) -> None:
        """Disarm a pending transfer/failure-cycle timer. Heap-backed
        engines hold EventHandles; the batch engine holds integer lane
        tokens, for which forgetting the token (the dict removal the
        caller already performs) *is* the cancellation."""
        h.cancel()

    # -- simulation-side timers (map milestones, background ticks) --------
    # Heap-backed engines schedule plain events; the batch engine routes
    # both through its calendar lane as typed records (same global seq
    # counter — identical merged order).
    def schedule_milestone(self, a: "SimAttempt", dt: float, idx: int,
                           frac: float, kind: str):
        """Arm the attempt's next map-milestone timer; returns the value
        ``a._milestone`` should hold (EventHandle or lane token)."""
        sim = self.sim
        return sim.engine.after(dt, sim._map_milestone_fired, a, frac,
                                kind)

    def schedule_tick(self, dt: float, which: int) -> None:
        """Arm one background tick (TICK_HB / TICK_EXPIRY)."""
        sim = self.sim
        fn = sim._heartbeat_tick if which == TICK_HB else sim._expiry_tick
        sim.engine.after(dt, fn)

    def verify_timer(self, a: "SimAttempt") -> None:
        """Consistency hook for a live ``a._milestone`` (verify_arrays)."""
        h = a._milestone
        if h is not None:
            assert not isinstance(h, int), a.attempt_id

    def try_start(self, a: "SimAttempt") -> None:
        raise NotImplementedError

    def _init_ready(self, a: "SimAttempt", ss: ShuffleState) -> None:
        raise NotImplementedError

    def _notify(self, task: "SimTask") -> None:
        raise NotImplementedError

    def _requeue(self, ss: ShuffleState, i: int, m: str) -> None:
        raise NotImplementedError

    def _mof_source(self, prod: "SimTask") -> Optional[str]:
        raise NotImplementedError

    def _drop_subscriptions(self, ss: ShuffleState) -> None:
        raise NotImplementedError

    def _drop_producer_subs(self, task_id: str) -> None:
        raise NotImplementedError


class RescanShuffle(ShuffleEngine):
    """The seed's poll-and-rescan algorithm, preserved as the equivalence
    reference: O(n_deps) candidate scan per free slot, completion
    broadcast to every running reduce attempt of the job, MOF sources by
    attribute scan. Status codes are maintained for the columnar shuffle
    columns but never drive control flow — the dict/set membership tests
    below are byte-for-byte the seed logic."""

    mode = "rescan"

    def _init_ready(self, a: "SimAttempt", ss: ShuffleState) -> None:
        sim = self.sim
        for i, m in enumerate(a.task.deps):
            prod = sim._task(m)
            if prod is not None and prod.state == TaskState.COMPLETED:
                ss.set_status(i, S_READY)

    def try_start(self, a: "SimAttempt") -> None:
        ss = a.shuffle
        if a.state != AttemptState.RUNNING or a.compute_started:
            return
        sim = self.sim
        prof = self.profile
        prof.try_calls += 1
        budget = sim.params.parallel_fetches - len(ss.inflight) \
            - len(ss.fail_cycles)
        if budget <= 0:
            return
        deps = a.task.deps
        dep_pos = a.task.dep_pos
        prof.deps_scanned += len(deps)
        candidates = [m for m in deps
                      if m not in ss.fetched and m not in ss.inflight
                      and m not in ss.fail_cycles]
        for m in candidates:
            if budget <= 0:
                break
            prod = sim._task(m)
            i = dep_pos[m]
            if prod is None or prod.state != TaskState.COMPLETED:
                # not produced yet; map completion will notify
                if ss.status[i] == S_READY:   # producer re-enqueued since
                    ss.set_status(i, S_WAITING)
                    self._arr_sh(a, ss)
                continue
            src = self._mof_source(prod)
            if src is None:
                ss.set_status(i, S_FAIL_CYCLE)
                self._launch_fail_cycle(a, ss, m)
                budget -= 1
                self._arr_sh(a, ss)
                continue
            ss.set_status(i, S_INFLIGHT)
            self._launch_fetch(a, ss, m, prod, src)
            budget -= 1
            self._arr_sh(a, ss)

    def _notify(self, task: "SimTask") -> None:
        # fresh MOF ⇒ every running reduce attempt of the job goes again
        m = task.task_id
        for r in task.job.reduces:
            for ra in r.running_attempts():
                ss = ra.shuffle
                i = ra.task.dep_pos.get(m)
                if i is not None:
                    st = int(ss.status[i])
                    if st == S_FAIL_CYCLE:
                        # cancel the pending failure cycle so the retry is
                        # immediate rather than waiting out the timeout
                        h = ss.fail_cycles.pop(m, None)
                        if h is not None:
                            self._cancel(h)
                    if st in (S_WAITING, S_FAIL_CYCLE):
                        ss.set_status(i, S_READY)
                        self._arr_sh(ra, ss)
                self.try_start(ra)

    def _requeue(self, ss: ShuffleState, i: int, m: str) -> None:
        ss.set_status(i, S_READY)

    def _mof_source(self, prod: "SimTask") -> Optional[str]:
        sim = self.sim
        down = sim._link_down
        for nid in prod.output_nodes:
            node = sim.cluster.nodes[nid]
            if node.alive and prod.task_id in node.mofs \
                    and nid not in sim._marked_failed \
                    and nid not in down:
                return nid
        return None

    def _drop_subscriptions(self, ss: ShuffleState) -> None:
        pass

    def _drop_producer_subs(self, task_id: str) -> None:
        pass


class EventShuffle(ShuffleEngine):
    """Event-driven candidate selection: each attempt keeps an indexed
    ready-deque (min-heap over dependency indices, lazily pruned), and a
    per-producer subscriber registry routes completion news to exactly
    the attempts still wanting that partition. Slot filling is O(log n)
    per slot; notification is O(interested attempts)."""

    mode = "event"

    def __init__(self, sim: "Simulation"):
        super().__init__(sim)
        # producer task_id → subscribed states (order irrelevant: fan-out
        # sorts by the canonical (task order, attempt index) key).
        self.subs: Dict[str, Dict[ShuffleState, None]] = {}
        # job → states parked with free budget + ready producers after a
        # silent abort (see mark_stalled); re-kicked on the job's next
        # producer completion, like the rescan broadcast would.
        self.stalled: Dict[object, Dict[ShuffleState, None]] = {}

    def mark_stalled(self, a: "SimAttempt") -> None:
        self.stalled.setdefault(a.task.job, {})[a.shuffle] = None

    def _init_ready(self, a: "SimAttempt", ss: ShuffleState) -> None:
        sim = self.sim
        subs = self.subs
        for i, m in enumerate(a.task.deps):
            subs.setdefault(m, {})[ss] = None
            prod = sim._task(m)
            if prod is not None and prod.state == TaskState.COMPLETED:
                ss.set_status(i, S_READY)
                heapq.heappush(ss.ready, i)

    def try_start(self, a: "SimAttempt") -> None:
        ss = a.shuffle
        if a.state != AttemptState.RUNNING or a.compute_started:
            return
        sim = self.sim
        prof = self.profile
        prof.try_calls += 1
        budget = sim.params.parallel_fetches - len(ss.inflight) \
            - len(ss.fail_cycles)
        if budget <= 0:
            return
        deps = a.task.deps
        ready = ss.ready
        changed = False
        while budget > 0 and ready:
            i = heapq.heappop(ready)
            prof.heap_pops += 1
            if ss.status[i] != S_READY:
                continue  # stale entry (lazy deletion)
            m = deps[i]
            prod = sim._task(m)
            if prod is None or prod.state != TaskState.COMPLETED:
                # producer re-enqueued since it went ready; its next
                # completion re-notifies (we stay subscribed)
                ss.set_status(i, S_WAITING)
                changed = True
                continue
            src = self._mof_source(prod)
            if src is None:
                ss.set_status(i, S_FAIL_CYCLE)
                self._launch_fail_cycle(a, ss, m)
                budget -= 1
                changed = True
                continue
            ss.set_status(i, S_INFLIGHT)
            d = self.subs.get(m)
            if d is not None:
                d.pop(ss, None)
            self._launch_fetch(a, ss, m, prod, src)
            budget -= 1
            changed = True
        if changed:
            self._arr_sh(a, ss)

    def _notify(self, task: "SimTask") -> None:
        m = task.task_id
        targets = dict(self.subs.get(m) or ())
        # States parked by a silent abort get the broadcast's re-kick on
        # any completion in their job, even if this producer is already
        # fetched for them (their try_start below restores the steady
        # state, so they leave the stalled set).
        stalled = self.stalled.pop(task.job, None)
        if stalled:
            targets.update(stalled)
        if not targets:
            return
        # canonical broadcast order: job's reduces in creation order, each
        # task's attempts in start order — matches the rescan reference
        for ss in sorted(targets, key=lambda s: s.key):
            a = ss.attempt
            if a.state != AttemptState.RUNNING:
                continue
            i = a.task.dep_pos[m]
            st = int(ss.status[i])
            if st == S_FAIL_CYCLE:
                # fresh MOF: cancel the pending failure cycle so the retry
                # is immediate rather than waiting out the timeout
                h = ss.fail_cycles.pop(m, None)
                if h is not None:
                    self._cancel(h)
            if st in (S_WAITING, S_FAIL_CYCLE):
                ss.set_status(i, S_READY)
                heapq.heappush(ss.ready, i)
                self._arr_sh(a, ss)
            self.try_start(a)

    def _requeue(self, ss: ShuffleState, i: int, m: str) -> None:
        ss.set_status(i, S_READY)
        heapq.heappush(ss.ready, i)
        self.subs.setdefault(m, {})[ss] = None

    def _mof_source(self, prod: "SimTask") -> Optional[str]:
        return self.registry.pick(prod)

    def _drop_subscriptions(self, ss: ShuffleState) -> None:
        deps = ss.attempt.task.deps
        for i in np.flatnonzero(ss.status <= _SUBSCRIBED_MAX):
            d = self.subs.get(deps[i])
            if d is not None:
                d.pop(ss, None)
        parked = self.stalled.get(ss.attempt.task.job)
        if parked is not None:
            parked.pop(ss, None)

    def _drop_producer_subs(self, task_id: str) -> None:
        self.subs.pop(task_id, None)

    def on_job_done(self, job) -> None:
        super().on_job_done(job)
        self.stalled.pop(job, None)

    def verify_state(self, a: "SimAttempt") -> None:
        super().verify_state(a)
        ss = a.shuffle
        deps = a.task.deps
        in_heap = set(ss.ready)
        for i in np.flatnonzero(ss.status == S_READY):
            assert int(i) in in_heap, (a.attempt_id, deps[i])
        if a.state == AttemptState.RUNNING:
            for i in np.flatnonzero(ss.status <= _SUBSCRIBED_MAX):
                assert ss in self.subs.get(deps[i], {}), \
                    (a.attempt_id, deps[i])


# BatchQueue record kinds (the shuffle owns the registry; 0 stays invalid
# so a zeroed record slot can never masquerade as a live event). Kinds 3/4
# carry the simulation's map-milestone ladder and fixed-rate background
# ticks as typed lane records (DESIGN.md §17): same global seq counter, so
# the merged order equals the heap-only order; their appliers obey the
# lane contract (neither can complete a job — reduce completions, the one
# job-finishing event, stay on the heap).
K_FETCH_DONE = 1
K_FAIL_CYCLE = 2
K_MILESTONE = 3    # obj = map SimAttempt, dep = milestone ladder index
K_TICK = 4         # obj = None, dep = TICK_* selector

TICK_HB = 0        # Simulation._heartbeat_tick
TICK_EXPIRY = 1    # Simulation._expiry_tick


class BatchShuffle(EventShuffle):
    """The macro-event fetch plane (DESIGN.md §14): EventShuffle's
    candidate selection with its three per-fetch overheads amortized
    away, trace-equivalently.

    1. **Timers → calendar-lane records.** Fetch completions and failure
       cycles are typed records in the engine's
       :class:`~repro_torch.sim.engine.BatchQueue` instead of per-event heap
       entries: no EventHandle, no args tuple, no generic dispatch.
       Cancellation is forgetting the record's integer token (the dict
       removal the canceller already performs); stale records are
       dropped at apply time by matching the token against the
       inflight/fail-cycle maps. A whole burst of records drains off one
       lane run between heap events, with the columnar
       ``fetched``/``sh_*`` write-through deferred per drain and flushed
       as one bulk store before the next heap event can read it.

    2. **Per-subscriber broadcast → completion log.** The event engine
       pays O(running reduce attempts) scalar status flips per map
       completion. Here a completion appends one entry to its job's
       *completion log*; each attempt holds a cursor (``ss.log_pos``)
       and reconciles the log delta **vectorized** (one mask over the
       int8 status column) the next time it selects candidates. This is
       trace-invariant because a WAITING→READY flip is unobservable
       until the attempt actually pops candidates: the live policies
       never read readiness (the ``sh_ready`` column is write-through
       telemetry), and ``try_start`` re-validates every popped index
       against the producer's current state exactly as the event engine
       does. The flip *is* observable for two groups, which keep an
       eager kick:

       - attempts burning a failure cycle for the completed producer
         (the pending timer must be cancelled now, not lazily) — the
         ``_fail_subs`` registry, populated only under faults;
       - attempts parked with free fetch budget (the event engine would
         launch at notify time) — the ``_idle`` set, which also absorbs
         EventShuffle's ``stalled`` bookkeeping (a silent abort parks
         the attempt exactly like budget starvation does).

       Attach vectorizes the same way: a fresh attempt starts its
       cursor at zero and reconciles the whole log in one mask instead
       of walking ``n_deps`` producer objects.

    3. **No-op fan-out → budget gate.** The eager kick only calls
       ``try_start`` when the attempt has (or just regained) free
       budget; for a saturated attempt the event engine's call provably
       returns without touching state, so skipping it is trace-inert.

    The fetch *transitions* stay sequential per record — flow counts
    feed the per-fetch throughput model, so end-flow/next-launch
    interleaving per completion is observable — the batching win is the
    machinery around them (``benchmarks/perf_shuffle.py`` gates ≥2×
    end-to-end over ``event`` at 1000 nodes).
    """

    mode = "batch"

    def __init__(self, sim: "Simulation"):
        super().__init__(sim)
        from repro_torch.sim.engine import BatchQueue
        self.batches = BatchQueue(sim.engine, self._apply_record,
                                  self._flush_dirty, drain=self._drain_run)
        # job → producer-completion log: one dependency index appended
        # per (re-)completion, in completion order. Never mutated in
        # place, only appended — cursors stay valid.
        self._logs: Dict[object, List[int]] = {}
        # job → attempts parked with free fetch budget (ready queue
        # drained, or silently aborted): the next completion in the job
        # re-kicks them, replacing both the per-producer subscriber
        # fan-out and EventShuffle's stalled set.
        self._idle: Dict[object, Dict[ShuffleState, None]] = {}
        # producer task_id → attempts burning a failure cycle against
        # it (eager cancellation on re-completion; faulted runs only).
        self._fail_subs: Dict[str, Dict[ShuffleState, None]] = {}
        # Deferred write-through: attempts whose shuffle columns changed
        # during the current lane drain.
        self._dirty: Dict["SimAttempt", None] = {}
        # Drain-boundary re-allocation registry (DESIGN.md §17.4, opt-in
        # via net_opts={"realloc": True} on the kernel engine): live
        # fetch token → (flow slot, launch rate). None = off (the
        # default; launches then skip the bookkeeping entirely).
        self._tok_rate: Optional[Dict[int, tuple]] = None
        self.n_reallocs = 0
        # Hot-path caches (immutable for the simulation's lifetime).
        self._psizes: Dict[object, float] = {}
        self._node_pos = sim.cluster._node_pos
        self._pf = sim.params.parallel_fetches
        self._cycle = sim.params.fetch_cycle
        self._bino = isinstance(sim.speculator, BinocularSpeculator)
        # Network fast path: only the seed-compat flat model may take the
        # hand-inlined rate/flow arithmetic below (it IS that model);
        # every other model goes through its open/close methods. The
        # ε-fair model re-solves its share tables once per drain run via
        # the lane's bracketing hooks (DESIGN.md §15.3).
        self._inline_flat = self._net.inline_flat
        if self._net.wants_drain_hook:
            self.batches.on_begin = self._net.begin_drain
            self.batches.on_end = self._net.end_drain

    @staticmethod
    def _cancel(h) -> None:
        """Lane tokens need no disarming — the caller's dict removal
        already orphaned the record (see BatchQueue)."""

    def _apply_tick(self, which: int) -> None:
        # Shared record machinery: only KernelShuffle *schedules* K_TICK
        # records, but the reference applier and the fused loop dispatch
        # them here (the generic-drain parity path runs under kernel too).
        sim = self.sim
        if which == TICK_HB:
            sim._heartbeat_tick()
        else:
            sim._expiry_tick()

    def _psize(self, job) -> float:
        s = self._psizes.get(job)
        if s is None:
            s = self._psizes[job] = job.spec.partition_bytes()
        return s

    # -- completion log ----------------------------------------------------
    def _reconcile(self, ss: ShuffleState) -> None:
        """Fold the job's completion-log delta into the status column:
        every WAITING dependency with a completion logged since this
        attempt last looked flips to READY, in one vectorized mask. A
        stale entry (producer re-enqueued since) yields a transient
        READY that ``try_start`` re-validates and parks back to WAITING
        — the same recovery the event engine performs on its own stale
        ready-heap entries."""
        log = ss.log
        pos = ss.log_pos
        n = len(log)
        if pos >= n:
            return
        ss.log_pos = n
        status = ss.status
        if n - pos == 1:  # steady state: one completion since last look
            i = log[pos]
            if status[i] == S_WAITING:
                status[i] = S_READY
                ss.n_ready += 1
                heapq.heappush(ss.ready, i)
            return
        idx = np.array(log[pos:], dtype=np.int64)
        # duplicates (producer completed twice within one delta) must
        # count once: unique BEFORE the mask so n_ready stays exact
        idx = np.unique(idx)
        flip = idx[status[idx] == S_WAITING]
        k = len(flip)
        if k:
            status[flip] = S_READY
            ss.n_ready += k
            ready = ss.ready
            if ready:
                for i in flip.tolist():
                    heapq.heappush(ready, i)
            else:
                # np.unique output is ascending — already a valid heap
                ss.ready = flip.tolist()

    def _init_ready(self, a: "SimAttempt", ss: ShuffleState) -> None:
        ss.log = self._logs.setdefault(a.task.job, [])
        ss.log_pos = 0
        self._reconcile(ss)

    # -- record application (reference path; the fused drain below must
    #    stay transition-identical — tests run both on one seeded sim) --
    def _apply_record(self, kind: int, a: "SimAttempt", i: int,
                      src_idx: int, token: int) -> None:
        self.profile.lane_records += 1
        if kind > K_FAIL_CYCLE:
            if kind == K_MILESTONE:
                # stale-token drop = cancellation (reschedule/teardown
                # moved the attempt's milestone past this record)
                if a._milestone == token:
                    a._milestone = None
                    self.sim._map_milestone_fired_idx(a, i)
            else:
                self._apply_tick(i)
            return
        if kind == K_FETCH_DONE and self._tok_rate is not None:
            # token dies with this pop, live or stale — slots recycle
            # (§17.4: realloc registry hygiene; mirrors the fused loop)
            self._tok_rate.pop(token, None)
        ss = a.shuffle
        if ss is None:
            return
        if kind == K_FETCH_DONE:
            # ---- one fetch completion: _fetch_done minus the handles
            m = a.task.deps[i]
            if ss.inflight.get(m) != token:
                return  # cancelled (detach/abort) or superseded re-fetch
            del ss.inflight[m]
            src = ss.fetch_srcs.pop(m, None)
            if src is not None:
                self._net.close_flow(src, a.node_id)
            if a.state != AttemptState.RUNNING:
                return
            ss.fetched.add(m)
            ss.status[i] = S_FETCHED  # from INFLIGHT: n_ready untouched
            self._dirty[a] = None
            sim = self.sim
            if self._bino:
                sim.speculator.note_fetch_ok(m)
            if len(ss.fetched) == len(a.task.deps):
                sim._start_compute(a)
            else:
                self.try_start(a)
            return
        self._apply_fail(a, ss, i, token)

    def _apply_fail(self, a: "SimAttempt", ss: ShuffleState, i: int,
                    token: int) -> None:
        """One burned failure cycle — ``_fetch_failed`` over the lane."""
        m = a.task.deps[i]
        if ss.fail_cycles.get(m) != token:
            return
        del ss.fail_cycles[m]
        d = self._fail_subs.get(m)
        if d is not None:
            d.pop(ss, None)
        if a.state != AttemptState.RUNNING:
            return
        ss.failed_cycles += 1
        sim = self.sim
        if sim.obs is not None:
            sim.obs.emit(K_FETCH_FAIL, a=sim.cluster._node_pos[a.node_id],
                         b=ss.failed_cycles, obj=m)
        sim._report_fetch_failure(a, m)
        prod = sim._task(m)
        if prod is not None and prod.state == TaskState.COMPLETED:
            self._requeue(ss, i, m)
        else:
            ss.set_status(i, S_WAITING)  # producer re-running; await notify
        self._dirty[a] = None
        if ss.failed_cycles >= sim.params.reduce_abort_cycles:
            sim._attempt_failed(a, reason="shuffle-exceeded-failures")
            return
        self.try_start(a)

    # -- fused drain loop ---------------------------------------------------
    def _drain_run(self, heap: list, until) -> bool:
        """The hot loop of the whole simulator at scale: pops due lane
        records and applies them with every piece of shared state bound
        once per drain run (~tens of records) instead of once per
        record. Semantics are pinned to the reference path above —
        ``_apply_record`` + ``try_start`` transition-for-transition; the
        equivalence fuzzer and the generic-drain parity test enforce it.
        Failure-cycle records (faults only) take the reference path."""
        q = self.batches
        lheap = q._heap
        eng = q.engine
        objs = q.objs
        free = q._free
        kind_v = q._kind
        dep_v = q._dep
        time_v = q._time
        row_v = q._row
        pay_v = q._payload
        time_v = q._time
        row_v = q._row
        pay_v = q._payload
        pop = heapq.heappop
        push = heapq.heappush
        sim = self.sim
        nodes = sim.cluster.nodes
        task_index = sim._task_index
        live_map = self.registry.live
        node_pos = self._node_pos
        net = self._net
        inline_net = self._inline_flat
        nf = net.node_flows
        psizes = self._psizes
        dirty = self._dirty
        idle = self._idle
        fail_subs = self._fail_subs
        pf = self._pf
        cycle = self._cycle
        bino = self._bino
        speculator = sim.speculator
        tok_rate = self._tok_rate
        arrs = sim.arrays
        arr_wd = arrs.work_done if arrs is not None else None
        arr_ls = arrs.last_sync if arrs is not None else None
        RUNNING = AttemptState.RUNNING
        T_COMPLETED = TaskState.COMPLETED
        # FairNetwork bulk mode (kernel drain): open/close stage only the
        # scalar flow-table fields while the drain holds shares frozen —
        # small enough to inline here, like the flat block below. The
        # staged arithmetic mirrors FairNetwork.open_flow/close_flow's
        # frozen branches field-for-field (the bulk-vs-incremental fuzz
        # differential pins it).
        bulk_net = (not inline_net) and getattr(net, "_bulk", False) \
            and net._frozen
        if bulk_net:
            pair = net._pair
            nfree = net._free
            f_active = net.f_active
            f_rate = net.f_rate
            f_si = net.f_si
            f_di = net.f_di
            # python-scalar reads: frozen shares + static rack layout
            share_l = net.link_share.tolist()
            rack_l = net._rack_py
            n_nodes = len(net.node_ids)
            nn2 = 2 * n_nodes
        n_records = 0
        n_pops = 0
        n_slots = 0
        n_try = 0
        paused = False
        while lheap:
            l0 = lheap[0]
            lt = l0[0]
            if heap:
                h0 = heap[0]
                ht = h0[0]
                if lt > ht or (lt == ht and l0[1] > h0[1]):
                    break
            if until is not None and lt > until:
                paused = True
                break
            eng.now = lt
            slot = pop(lheap)[2]
            if kind_v is not q._kind:  # store grew mid-drain
                kind_v = q._kind
                dep_v = q._dep
                time_v = q._time
                row_v = q._row
                pay_v = q._payload
            a = objs[slot]
            objs[slot] = None
            i = int(dep_v[slot])
            k = kind_v[slot]
            free.append(slot)  # popped ⇒ recyclable (reads done above)
            n_records += 1
            if k != K_FETCH_DONE:
                if k == K_MILESTONE:
                    # ---- map-milestone ladder (kernel mode only; the
                    # map phase's hot loop). The common transition — an
                    # on-schedule spill with the node still at speed —
                    # is `_map_milestone_fired` + `_schedule_map_
                    # milestone` inlined arithmetic-for-arithmetic
                    # (sync fold, max clamp, ladder scan); everything
                    # else (slowdown recheck, disk exception,
                    # completion) drops to the reference path.
                    if a._milestone != slot:
                        continue  # stale: rescheduled or torn down
                    a._milestone = None
                    if a.state is not RUNNING:
                        continue
                    cache = a._milestones_cache
                    if cache is not None and \
                            cache[0] == a.disk_exception_at:
                        pts = cache[1]
                    else:
                        pts = sim._map_milestones(a)
                    p = pts[i]
                    frac = p[0]
                    node = nodes[a.node_id]
                    speed = node.speed
                    wt = a.work_total
                    wd = a.work_done + (lt - a.last_sync) * speed
                    if wd > wt:
                        wd = wt
                    target = frac * wt
                    if p[1] != "spill" or wd + 1e-9 < target:
                        sim._map_milestone_fired(a, frac, p[1])
                        kind_v = q._kind
                        dep_v = q._dep
                        time_v = q._time
                        row_v = q._row
                        pay_v = q._payload
                        continue
                    if target > wd:
                        wd = target
                    a.work_done = wd
                    a.last_sync = lt
                    row_a = a.row
                    if row_a >= 0:
                        if arr_wd is not arrs.work_done:
                            arr_wd = arrs.work_done  # grew mid-drain
                            arr_ls = arrs.last_sync
                        arr_wd[row_a] = wd
                        arr_ls[row_a] = lt
                    tid = a.task.task_id
                    sl = node.spill_logs
                    prev = sl.get(tid)
                    if prev is None or frac > prev:
                        sl[tid] = frac
                    if bino:
                        speculator.record_progress_log(ProgressLog(
                            task_id=tid, node_id=a.node_id, offset=frac))
                    if speed <= 0.0:
                        continue  # frozen; expiry/death cleans up
                    thresh = wd / wt + 1e-12
                    nxt = 0
                    npts = len(pts)
                    while nxt < npts and pts[nxt][0] <= thresh:
                        nxt += 1
                    if nxt == npts:  # degenerate: ladder exhausted
                        sim._schedule_map_milestone(a)
                        kind_v = q._kind
                        dep_v = q._dep
                        time_v = q._time
                        row_v = q._row
                        pay_v = q._payload
                        continue
                    dt = (pts[nxt][0] * wt - wd) / speed
                    if free:
                        tok = free.pop()
                        objs[tok] = a
                    else:
                        tok = q._n
                        if tok == len(q.recs):
                            q._grow()
                            kind_v = q._kind
                            dep_v = q._dep
                            time_v = q._time
                            row_v = q._row
                            pay_v = q._payload
                        q._n = tok + 1
                        objs.append(a)
                    t2 = lt + dt if dt > 0.0 else lt
                    kind_v[tok] = K_MILESTONE
                    time_v[tok] = t2
                    row_v[tok] = row_a
                    dep_v[tok] = nxt
                    pay_v[tok] = 0
                    push(lheap, (t2, eng._seq, tok))
                    eng._seq += 1
                    a._milestone = tok
                    continue
                # rare kinds (faults, background ticks): reference
                # paths; they may re-enter try_start/schedule and grow
                # the store — rebind defensively after
                if k == K_FAIL_CYCLE:
                    ss = a.shuffle
                    if ss is not None:
                        self._apply_fail(a, ss, i, slot)
                else:  # K_TICK
                    self._apply_tick(i)
                kind_v = q._kind
                dep_v = q._dep
                time_v = q._time
                row_v = q._row
                pay_v = q._payload
                continue
            # ---- fetch completion (== _apply_record's hot branch) ----
            if tok_rate is not None:
                # The token dies with this pop — live or stale. Lane
                # slots recycle, so a leftover entry would silently
                # re-key itself to whatever fetch is issued the slot
                # next (§17.4: realloc registry hygiene).
                tok_rate.pop(slot, None)
            ss = a.shuffle
            if ss is None:
                continue
            deps = a.task.deps
            m = deps[i]
            inflight = ss.inflight
            if inflight.get(m) != slot:
                continue  # cancelled or superseded re-fetch
            del inflight[m]
            src = ss.fetch_srcs.pop(m, None)
            dst = a.node_id
            if src is not None:
                if inline_net:
                    sn = nodes[src]
                    dn = nodes[dst]
                    f = sn.active_flows - 1
                    sn.active_flows = f if f > 0 else 0
                    f = dn.active_flows - 1
                    dn.active_flows = f if f > 0 else 0
                    nf[node_pos[src]] = sn.active_flows
                    nf[node_pos[dst]] = dn.active_flows
                elif bulk_net:
                    # staged close: the slot dies now, count tables
                    # catch up in the end_drain rebuild
                    key = (src, dst)
                    slots_f = pair[key]
                    slot_f = slots_f.pop()
                    if not slots_f:
                        del pair[key]
                    f_active[slot_f] = False
                    f_rate[slot_f] = 0.0
                    net.n_flows -= 1
                    nfree.append(slot_f)
                    net._stale = True
                else:
                    net.close_flow(src, dst)
            if a.state is not RUNNING:
                continue
            fetched = ss.fetched
            fetched.add(m)
            status = ss.status
            status[i] = S_FETCHED  # from INFLIGHT: n_ready untouched
            dirty[a] = None
            if bino:
                speculator.note_fetch_ok(m)
            if len(fetched) == len(deps):
                sim._start_compute(a)
                continue
            # ---- inline try_start (state/compute checks hold: the
            #      attempt is RUNNING and still missing partitions) ----
            fail_cycles = ss.fail_cycles
            budget = pf - len(inflight) - len(fail_cycles)
            if budget <= 0:
                continue
            n_try += 1
            if ss.log_pos < len(ss.log):
                self._reconcile(ss)
            ready = ss.ready
            changed = False
            while budget > 0 and ready:
                j = pop(ready)
                n_pops += 1
                if status[j] != S_READY:
                    continue  # stale entry (lazy deletion)
                m2 = deps[j]
                prod = task_index.get(m2)
                if prod is None or prod.state is not T_COMPLETED:
                    status[j] = S_WAITING  # re-enqueued; next completion
                    ss.n_ready -= 1       # re-logs it
                    changed = True
                    continue
                src2 = None
                live = live_map.get(m2)
                if live:
                    for nid in prod.output_nodes:
                        if nid in live:
                            src2 = nid
                            break
                if src2 is None:
                    status[j] = S_FAIL_CYCLE
                    ss.n_ready -= 1
                    if free:
                        tok = free.pop()
                        objs[tok] = a
                    else:
                        tok = q._n
                        if tok == len(q.recs):
                            q._grow()
                            kind_v = q._kind
                            dep_v = q._dep
                            time_v = q._time
                            row_v = q._row
                            pay_v = q._payload
                        q._n = tok + 1
                        objs.append(a)
                    t2 = lt + cycle
                    kind_v[tok] = K_FAIL_CYCLE
                    time_v[tok] = t2
                    row_v[tok] = a.row
                    dep_v[tok] = j
                    pay_v[tok] = 0
                    push(lheap, (t2, eng._seq, tok))
                    eng._seq += 1
                    fail_cycles[m2] = tok
                    fail_subs.setdefault(m2, {})[ss] = None
                    n_slots += 1
                    budget -= 1
                    changed = True
                    continue
                status[j] = S_INFLIGHT
                ss.n_ready -= 1
                if inline_net:
                    # per-flow rate decided at flow start (the seed-
                    # compat flat model's fetch_throughput arithmetic)
                    sn = nodes[src2]
                    dn = nodes[dst]
                    if src2 == dst:
                        rate = DISK_BW / (sn.active_flows + 1)
                    else:
                        sf = sn.active_flows + 1
                        df = dn.active_flows + 1
                        rate = NIC_BW / (sf if sf > df else df)
                    sn.active_flows += 1
                    dn.active_flows += 1
                    nf[node_pos[src2]] = sn.active_flows
                    nf[node_pos[dst]] = dn.active_flows
                elif bulk_net:
                    # staged open priced against the frozen shares
                    si = node_pos[src2]
                    if src2 == dst:
                        di = si
                        r = share_l[n_nodes + si]
                    else:
                        di = node_pos[dst]
                        r = share_l[si]
                        x = share_l[di]
                        if x < r:
                            r = x
                        rs = rack_l[si]
                        rd = rack_l[di]
                        if rs != rd:
                            x = share_l[nn2 + rs]
                            if x < r:
                                r = x
                            x = share_l[nn2 + rd]
                            if x < r:
                                r = x
                    rate = r if r > 1.0 else 1.0
                    if nfree:
                        slot_f = nfree.pop()
                    else:
                        slot_f = net._alloc()
                        f_active = net.f_active  # grow may swap stores
                        f_rate = net.f_rate
                        f_si = net.f_si
                        f_di = net.f_di
                    net.last_slot = slot_f
                    f_si[slot_f] = si
                    f_di[slot_f] = di
                    f_active[slot_f] = True
                    net.n_flows += 1
                    key2 = (src2, dst)
                    plist = pair.get(key2)
                    if plist is None:
                        pair[key2] = [slot_f]
                    else:
                        plist.append(slot_f)
                    net._stale = True
                else:
                    rate = net.open_flow(src2, dst)
                ss.fetch_srcs[m2] = src2
                job2 = prod.job
                size = psizes.get(job2)
                if size is None:
                    size = psizes[job2] = job2.spec.partition_bytes()
                dt = size / rate
                if dt < 1e-3:
                    dt = 1e-3
                if free:
                    tok = free.pop()
                    objs[tok] = a
                else:
                    tok = q._n
                    if tok == len(q.recs):
                        q._grow()
                        kind_v = q._kind
                        dep_v = q._dep
                        time_v = q._time
                        row_v = q._row
                        pay_v = q._payload
                    q._n = tok + 1
                    objs.append(a)
                t2 = lt + dt
                kind_v[tok] = K_FETCH_DONE
                time_v[tok] = t2
                row_v[tok] = a.row
                dep_v[tok] = j
                pay_v[tok] = node_pos[src2]
                push(lheap, (t2, eng._seq, tok))
                eng._seq += 1
                inflight[m2] = tok
                if tok_rate is not None:
                    tok_rate[tok] = (net.last_slot, rate)
                n_slots += 1
                budget -= 1
                changed = True
            if changed:
                dirty[a] = None
            if budget > 0:
                if not ss.parked:
                    ss.parked = True
                    idle.setdefault(a.task.job, {})[ss] = None
            elif ss.parked:
                ss.parked = False
                d = idle.get(a.task.job)
                if d is not None:
                    d.pop(ss, None)
        prof = self.profile
        prof.lane_records += n_records
        prof.heap_pops += n_pops
        prof.slots_filled += n_slots
        prof.try_calls += n_try
        q.applied += n_records
        return paused

    # -- deferred columnar write-through -----------------------------------
    def _arr_sh(self, a: "SimAttempt", ss: ShuffleState) -> None:
        if self.batches.in_drain:
            self._dirty[a] = None
        elif a.row >= 0:
            arr = self.sim.arrays
            arr.fetched[a.row] = len(ss.fetched)
            arr.sh_ready[a.row] = ss.n_ready
            arr.sh_inflight[a.row] = len(ss.inflight)
            arr.sh_fail[a.row] = len(ss.fail_cycles)

    def _flush_dirty(self) -> None:
        d = self._dirty
        if not d:
            return
        arr = self.sim.arrays
        if arr is not None:
            if len(d) > 3:
                rows = []
                fetched = []
                ready = []
                inflight = []
                fail = []
                for a in d:
                    if a.row < 0:
                        continue
                    ss = a.shuffle
                    rows.append(a.row)
                    fetched.append(len(ss.fetched))
                    ready.append(ss.n_ready)
                    inflight.append(len(ss.inflight))
                    fail.append(len(ss.fail_cycles))
                if rows:
                    arr.write_shuffle_rows(rows, fetched, ready, inflight,
                                           fail)
            else:
                for a in d:
                    if a.row < 0:
                        continue
                    ss = a.shuffle
                    r = a.row
                    arr.fetched[r] = len(ss.fetched)
                    arr.sh_ready[r] = ss.n_ready
                    arr.sh_inflight[r] = len(ss.inflight)
                    arr.sh_fail[r] = len(ss.fail_cycles)
        d.clear()

    # -- candidate selection -----------------------------------------------
    # (The base-class _launch_fetch/_launch_fail_cycle hooks are not
    # overridden: batch mode's only launch sites are the two inlined
    # schedulers in try_start and _drain_run below.)
    def try_start(self, a: "SimAttempt") -> None:
        """EventShuffle.try_start transition-for-transition, with the
        sub-calls (set_status, registry.pick, fetch_throughput, timer
        scheduling) inlined over local binds, the completion-log
        reconcile up front, and the idle-set bookkeeping at the end."""
        ss = a.shuffle
        if a.state != AttemptState.RUNNING or a.compute_started:
            return
        sim = self.sim
        prof = self.profile
        prof.try_calls += 1
        inflight = ss.inflight
        fail_cycles = ss.fail_cycles
        budget = self._pf - len(inflight) - len(fail_cycles)
        if budget <= 0:
            return
        if ss.log_pos < len(ss.log):
            self._reconcile(ss)
        deps = a.task.deps
        ready = ss.ready
        status = ss.status
        task_index = sim._task_index
        live_map = self.registry.live
        nodes = sim.cluster.nodes
        batches = self.batches
        net = self._net
        inline_net = self._inline_flat
        nf = net.node_flows
        node_pos = self._node_pos
        now = sim.engine.now
        dst = a.node_id
        row = a.row
        changed = False
        while budget > 0 and ready:
            i = heapq.heappop(ready)
            prof.heap_pops += 1
            if status[i] != S_READY:
                continue  # stale entry (lazy deletion)
            m = deps[i]
            prod = task_index.get(m)
            if prod is None or prod.state != TaskState.COMPLETED:
                # producer re-enqueued since it went ready; its next
                # completion re-logs it
                status[i] = S_WAITING
                ss.n_ready -= 1
                changed = True
                continue
            src = None
            live = live_map.get(m)
            if live:
                for nid in prod.output_nodes:
                    if nid in live:
                        src = nid
                        break
            if src is None:
                status[i] = S_FAIL_CYCLE
                ss.n_ready -= 1
                fail_cycles[m] = batches.schedule(
                    now + self._cycle, K_FAIL_CYCLE, a, row, i, 0)
                self._fail_subs.setdefault(m, {})[ss] = None
                prof.slots_filled += 1
                budget -= 1
                changed = True
                continue
            status[i] = S_INFLIGHT
            ss.n_ready -= 1
            if inline_net:
                # inline _launch_fetch (the seed-compat flat model's
                # fetch_throughput semantics: quasi-static per-flow
                # rate decided at flow start)
                sn = nodes[src]
                dn = nodes[dst]
                if src == dst:
                    rate = DISK_BW / (sn.active_flows + 1)
                else:
                    sf = sn.active_flows + 1
                    df = dn.active_flows + 1
                    rate = NIC_BW / (sf if sf > df else df)
                sn.active_flows += 1
                dn.active_flows += 1
                nf[node_pos[src]] = sn.active_flows
                nf[node_pos[dst]] = dn.active_flows
            else:
                rate = net.open_flow(src, dst)
            ss.fetch_srcs[m] = src
            dt = self._psize(prod.job) / rate
            if dt < 1e-3:
                dt = 1e-3
            tok = batches.schedule(
                now + dt, K_FETCH_DONE, a, row, i, self._node_pos[src])
            inflight[m] = tok
            tr = self._tok_rate
            if tr is not None:
                tr[tok] = (net.last_slot, rate)
            prof.slots_filled += 1
            budget -= 1
            changed = True
        if changed:
            self._arr_sh(a, ss)
        if budget > 0:
            # candidates exhausted with budget to spare: park for the
            # job's next completion (the event broadcast's re-kick)
            if not ss.parked:
                ss.parked = True
                self._idle.setdefault(a.task.job, {})[ss] = None
        elif ss.parked:
            ss.parked = False
            d = self._idle.get(a.task.job)
            if d is not None:
                d.pop(ss, None)

    def mark_stalled(self, a: "SimAttempt") -> None:
        ss = a.shuffle
        if not ss.parked:
            ss.parked = True
            self._idle.setdefault(a.task.job, {})[ss] = None

    # -- eager notification (the log handles the rest) ---------------------
    def _notify(self, task: "SimTask") -> None:
        """Append to the completion log, then kick only the attempts for
        which the event broadcast's visit is observable *now*: failure
        cycles against this producer are cancelled (their timer must
        not fire), and parked attempts with free budget re-select (the
        event engine would launch at notify time). Everyone else picks
        the completion up from the log on their next selection."""
        m = task.task_id
        self._logs.setdefault(task.job, []).append(task.index)
        targets = self._idle.pop(task.job, None) or {}
        for ss in targets:
            ss.parked = False  # consumed; try_start below re-parks
        fs = self._fail_subs.get(m)
        if fs:
            targets = dict(targets)
            targets.update(fs)
        if not targets:
            return
        pf = self._pf
        for ss in sorted(targets, key=lambda s: s.key):
            a = ss.attempt
            if a.state != AttemptState.RUNNING:
                continue
            i = a.task.dep_pos[m]
            if ss.status[i] == S_FAIL_CYCLE:
                # fresh MOF: drop the pending failure cycle so the retry
                # is immediate rather than waiting out the timeout
                ss.fail_cycles.pop(m, None)
                if fs is not None:
                    fs.pop(ss, None)
                ss.set_status(i, S_READY)
                heapq.heappush(ss.ready, i)
                self._arr_sh(a, ss)
            if pf - len(ss.inflight) - len(ss.fail_cycles) > 0:
                self.try_start(a)

    def _requeue(self, ss: ShuffleState, i: int, m: str) -> None:
        ss.set_status(i, S_READY)
        heapq.heappush(ss.ready, i)

    # -- registries / lifecycle --------------------------------------------
    def _drop_subscriptions(self, ss: ShuffleState) -> None:
        deps = ss.attempt.task.deps
        for i in np.flatnonzero(ss.status == S_FAIL_CYCLE):
            d = self._fail_subs.get(deps[i])
            if d is not None:
                d.pop(ss, None)
        if ss.parked:
            ss.parked = False
            d = self._idle.get(ss.attempt.task.job)
            if d is not None:
                d.pop(ss, None)

    def _drop_producer_subs(self, task_id: str) -> None:
        self._fail_subs.pop(task_id, None)

    def on_job_done(self, job) -> None:
        ShuffleEngine.on_job_done(self, job)
        self._logs.pop(job, None)
        self._idle.pop(job, None)
        self._psizes.pop(job, None)

    # -- consistency ---------------------------------------------------------
    def verify_state(self, a: "SimAttempt") -> None:
        ShuffleEngine.verify_state(self, a)
        ss = a.shuffle
        deps = a.task.deps
        in_heap = set(ss.ready)
        for i in np.flatnonzero(ss.status == S_READY):
            assert int(i) in in_heap, (a.attempt_id, deps[i])
        # the cursor never outruns the log
        log = self._logs.get(a.task.job)
        assert log is not None and log is ss.log, a.attempt_id
        assert ss.log_pos <= len(log), (a.attempt_id, ss.log_pos)
        # the parked flag mirrors idle-set membership exactly
        assert ss.parked == (
            ss in self._idle.get(a.task.job, {})), (a.attempt_id, ss.parked)
        # a WAITING dep whose producer is COMPLETED must have its
        # completion still pending in the log delta (else it could
        # never become READY again)
        sim = self.sim
        pending = set(log[ss.log_pos:])
        for i in np.flatnonzero(ss.status == S_WAITING):
            prod = sim._task(deps[i])
            if prod is not None and prod.state == TaskState.COMPLETED:
                assert int(i) in pending, (a.attempt_id, deps[i])
        if a.state == AttemptState.RUNNING:
            for i in np.flatnonzero(ss.status == S_FAIL_CYCLE):
                assert ss in self._fail_subs.get(deps[i], {}), \
                    (a.attempt_id, deps[i])
        # every live timer token references a pending, matching record
        q = self.batches
        for src_map, want in ((ss.inflight, K_FETCH_DONE),
                              (ss.fail_cycles, K_FAIL_CYCLE)):
            for m, tok in src_map.items():
                assert isinstance(tok, int), (a.attempt_id, m, tok)
                assert 0 <= tok < q._n, (a.attempt_id, m, tok, q._n)
                assert q.objs[tok] is a, (a.attempt_id, m)
                assert int(q._kind[tok]) == want, (a.attempt_id, m)
                assert int(q._dep[tok]) == a.task.dep_pos[m], \
                    (a.attempt_id, m)


class KernelShuffle(BatchShuffle):
    """Bulk-launch drain (DESIGN.md §17): BatchShuffle with the three
    residual per-record Python paths kernelized.

    1. **Map milestones as lane records** (``K_MILESTONE``): the ladder
       advances through typed ``(row, frac-index, kind)`` records on the
       calendar lane instead of per-attempt ``engine.after`` callbacks.
       Records draw from the same global seq counter the heap uses, so
       on the count-based networks (flat/topo) the merged event order —
       and therefore every trace — is byte-identical to BatchShuffle.
    2. **Background ticks as lane records** (``K_TICK``): heartbeat and
       NM-expiry scans ride the lane too, removing the last per-sim-
       second heap events. Drains then span whole heap-event gaps,
       which under ``FairNetwork`` coarsens the recompute cadence — the
       documented trace-shift waiver (§17.3); flat/topo are unaffected
       (rates there read live counts, not drain-frozen shares).
    3. **Bulk flow accounting** on a ``FairNetwork`` in drain mode:
       per-flow open/close bookkeeping is staged during the drain
       (shares are frozen, so the tables are dead until end-of-drain
       anyway) and applied in one vectorized step by ``end_drain``;
       the water-fill solve itself sits behind a pluggable bulk
       backend (not ported yet: flat networks never take this path).

    Everything else — record layout, the fused drain loop's fetch hot
    path, cancellation discipline — is inherited; the differential
    fuzzer pins kernel ≡ batch byte-for-byte on flat/topo.
    """

    mode = "kernel"

    def __init__(self, sim: "Simulation") -> None:
        super().__init__(sim)
        net = self._net
        if getattr(net, "supports_bulk", False):
            net.enable_bulk()
            if net.realloc:
                # §17.4 waiver: opt-in re-pricing of in-flight transfers
                # at every drain boundary that re-solved the shares.
                # Traces shift by design (completion times move), so the
                # fuzz matrix excludes realloc runs from byte-equivalence
                # and pins invariants instead.
                self._tok_rate = {}
                self.batches.on_begin = self._realloc_begin

    def _realloc_begin(self) -> None:
        """begin_drain plus §17.4 re-allocation: when the solve actually
        ran (shares moved), re-price every live in-flight fetch with the
        batch pricing rule (``BulkBackend.price`` — one vectorized step,
        the Pallas kernel's production call site) and slide its lane
        record: remaining bytes at the old rate, completion at the new.
        Token-forgetting does the cancellation — the superseded record
        stale-drops at pop because ``ss.inflight`` now maps to the new
        token."""
        net = self._net
        before = net.n_recomputes
        net.begin_drain()
        tr = self._tok_rate
        if net.n_recomputes == before or not tr:
            return
        q = self.batches
        kind_v = q._kind
        dep_v = q._dep
        time_v = q._time
        objs = q.objs
        now = q.engine.now
        live = []
        for tok, (slot, rate_old) in list(tr.items()):
            # A registry entry can outlive its record (normal pops and
            # stale drops don't clean it): validate against the live
            # store. A recycled token is either overwritten at its next
            # fetch launch or fails these checks.
            a = objs[tok] if kind_v[tok] == K_FETCH_DONE else None
            ss = a.shuffle if a is not None else None
            if ss is None or \
                    ss.inflight.get(a.task.deps[dep_v[tok]]) != tok:
                del tr[tok]
                continue
            # capture the record fields now: scheduling the replacement
            # records below may grow (and swap) the column stores
            live.append((tok, slot, rate_old, a, ss, float(time_v[tok]),
                         int(dep_v[tok]), int(q._payload[tok])))
        if not live:
            return
        slots = np.fromiter((e[1] for e in live), dtype=np.int64,
                            count=len(live))
        links = net.f_links[slots]
        rates = net._backend.price(net.link_share, links, links >= 0)
        for k, (tok, slot, rate_old, a, ss, t_done, i, pay) in \
                enumerate(live):
            r_new = float(rates[k])
            if r_new == rate_old:
                continue
            rem = (t_done - now) * rate_old
            if rem < 0.0:
                rem = 0.0
            dt = rem / r_new
            if dt < 1e-3:
                dt = 1e-3
            new_tok = q.schedule(now + dt, K_FETCH_DONE, a, a.row, i, pay)
            ss.inflight[a.task.deps[i]] = new_tok
            del tr[tok]
            tr[new_tok] = (slot, r_new)
            self.n_reallocs += 1

    # -- simulation-side timers as lane records (DESIGN.md §17) -----------
    def schedule_milestone(self, a: "SimAttempt", dt: float, idx: int,
                           frac: float, kind: str):
        eng = self.sim.engine
        t = eng.now + (dt if dt > 0.0 else 0.0)
        return self.batches.schedule(t, K_MILESTONE, a, a.row, idx, 0)

    def schedule_tick(self, dt: float, which: int) -> None:
        eng = self.sim.engine
        t = eng.now + (dt if dt > 0.0 else 0.0)
        self.batches.schedule(t, K_TICK, None, -1, which, 0)

    def verify_timer(self, a: "SimAttempt") -> None:
        tok = a._milestone
        if not isinstance(tok, int):
            return  # reduce-completion timers stay heap EventHandles
        q = self.batches
        assert 0 <= tok < q._n, (a.attempt_id, tok, q._n)
        assert q.objs[tok] is a, a.attempt_id
        assert int(q._kind[tok]) == K_MILESTONE, a.attempt_id


def make_engine(sim: "Simulation", mode: str) -> ShuffleEngine:
    if mode == "batch":
        return BatchShuffle(sim)
    if mode == "kernel":
        return KernelShuffle(sim)
    if mode == "event":
        return EventShuffle(sim)
    if mode == "rescan":
        return RescanShuffle(sim)
    raise ValueError(f"unknown shuffle mode: {mode!r}")
