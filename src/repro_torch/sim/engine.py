"""Deterministic discrete-event engine.

No wall-clock, no threads: a single heap of (time, seq, callback) with a
monotone sequence number for stable ordering of simultaneous events. All
randomness in the simulator flows through one seeded ``numpy`` Generator,
so every benchmark row is bit-reproducible.

Beside the heap there is an optional **calendar lane** of typed
macro-event records (:class:`BatchQueue`, DESIGN.md §14): high-volume
homogeneous events (the shuffle's fetch completions and failure cycles)
are stored as structured numpy records instead of per-event heap entries
with callback tuples and cancellation handles. The run loop drains every
lane record whose ``(time, seq)`` key precedes the heap head in one
step, so a whole burst of fetch-state transitions is applied without
re-entering the generic event machinery, then flushes the consumer's
deferred column write-through before the next heap event can observe it.
Both sources draw their tiebreak sequence from the same counter, so the
merged order is exactly the order a heap-only engine would produce.
"""
from __future__ import annotations

import heapq
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.obs.trace import K_DRAIN as _K_DRAIN


class Cancelled(Exception):
    pass


class EventHandle:
    __slots__ = ("cancelled",)

    def __init__(self):
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class BatchQueue:
    """Calendar lane of typed macro-event records beside the engine heap.

    A record is ``(kind, time, row, dep, payload)`` in one structured
    numpy array (plus a parallel python rail holding the owning object,
    like the id rails of ``ArraySnapshot``); ordering lives in a small
    heap of ``(time, seq, slot)`` keys whose ``seq`` comes from the
    engine's global counter. Records carry no cancellation handle: the
    consumer's ``apply`` callback re-validates each record against its
    authoritative state (the shuffle engine matches the record's token
    against its inflight/fail-cycle maps) and silently drops stale ones
    — cancellation is just forgetting the token.

    Contract for appliers (what lets the run loop amortize per-event
    work): a record application must not complete a job or otherwise
    flip a ``run(stop=...)`` condition — the loop only re-checks
    ``stop`` per *heap* event. Appliers may defer column write-through
    while ``in_drain`` is set; ``flush`` runs before every heap event
    and before ``run`` returns, so no reader can observe deferred state.
    """

    DTYPE = np.dtype([("kind", np.int8), ("time", np.float64),
                      ("row", np.int32), ("dep", np.int32),
                      ("payload", np.int32)])

    __slots__ = ("engine", "recs", "objs", "_heap", "_n", "_free",
                 "_apply", "_flush", "_drain_impl", "_kind", "_time",
                 "_row", "_dep", "_payload", "in_drain", "applied",
                 "on_begin", "on_end", "obs")

    def __init__(self, engine: "Engine", apply: Callable, flush: Callable,
                 drain: Optional[Callable] = None, cap: int = 1024):
        self.engine = engine
        self.recs = np.zeros(cap, dtype=self.DTYPE)
        self.objs: List[object] = []
        self._heap: List[Tuple[float, int, int]] = []
        self._n = 0
        # Popped slots are recycled (a slot is reusable the moment its
        # record leaves the heap: every live token is a *pending* record,
        # so no consumer can still hold a freed slot's token). Without
        # this the store could only reset when the lane fully drained —
        # impossible once self-rescheduling tick records live here.
        self._free: List[int] = []
        self._apply = apply
        self._flush = flush
        # Consumers may supply a fused drain loop (the shuffle engine
        # binds its hot state once per drain run instead of once per
        # record); the generic loop below is the reference — the two
        # must apply identical transitions (tests pin this by running
        # the same seeded simulation under both).
        self._drain_impl = drain if drain is not None else \
            self._generic_drain
        self._cache_views()
        self.in_drain = False
        self.applied = 0  # records applied (profiling; incl. stale drops)
        # Optional drain brackets (consumer-set): the ε-fair network
        # model re-solves its share tables once per drain run here
        # (DESIGN.md §15.3) — shared by the fused and generic loops, so
        # the drain-parity tests exercise identical rate schedules.
        self.on_begin: Optional[Callable] = None
        self.on_end: Optional[Callable] = None
        # Optional flight recorder (repro_torch.obs): one drain-summary record
        # per drain run, no per-record cost.
        self.obs = None
        engine.attach_lane(self)

    def _cache_views(self) -> None:
        r = self.recs
        self._kind = r["kind"]
        self._time = r["time"]
        self._row = r["row"]
        self._dep = r["dep"]
        self._payload = r["payload"]

    def _grow(self) -> None:
        new = np.zeros(2 * len(self.recs), dtype=self.DTYPE)
        new[:self._n] = self.recs[:self._n]
        self.recs = new
        self._cache_views()

    def __len__(self) -> int:
        return len(self._heap)

    def schedule(self, t: float, kind: int, obj: object, row: int,
                 dep: int, payload: int) -> int:
        """Append one record; returns its slot id — the *token* the
        consumer stores wherever it would have stored an EventHandle.
        Slots are unique for the life of the pending set: a slot is
        freed (and may be reissued) only when its record pops off the
        lane heap, at which point any dangling copy of the token has
        already been forgotten or invalidated by the applier."""
        eng = self.engine
        assert t >= eng.now - 1e-9, (t, eng.now)
        if self._free:
            slot = self._free.pop()
            self.objs[slot] = obj
        else:
            slot = self._n
            if slot == len(self.recs):
                self._grow()
            self._n = slot + 1
            self.objs.append(obj)
        self._kind[slot] = kind
        self._time[slot] = t
        self._row[slot] = row
        self._dep[slot] = dep
        self._payload[slot] = payload
        heapq.heappush(self._heap, (t, eng._seq, slot))
        eng._seq += 1
        return slot

    def drain(self, heap: list, until: Optional[float]) -> bool:
        """Apply every record whose ``(time, seq)`` key precedes the
        engine heap's head event (re-peeking the heap per record, since
        an application may schedule an earlier event), advancing
        ``engine.now`` per record. Returns True when the drain paused at
        ``until`` (records beyond it stay queued). Deferred write-through
        is flushed on every exit path; the record store resets once the
        lane fully drains (every live token is a pending record, so an
        empty heap means no token dangles)."""
        self.in_drain = True
        rec = self.obs
        if rec is not None:
            t0 = self.engine.now
            n0 = self.applied
        if self.on_begin is not None:
            self.on_begin()
        try:
            paused = self._drain_impl(heap, until)
        finally:
            self.in_drain = False
            if self.on_end is not None:
                self.on_end()
            self._flush()
            if rec is not None:
                rec.emit(_K_DRAIN, b=self.applied - n0, f0=t0)
        if not self._heap:
            self._n = 0
            self.objs.clear()
            self._free.clear()
        return paused

    def _generic_drain(self, heap: list, until: Optional[float]) -> bool:
        """Reference drain loop: one ``apply(kind, obj, dep, payload,
        token)`` call per due record."""
        lheap = self._heap
        eng = self.engine
        apply = self._apply
        objs = self.objs
        kind_v = self._kind
        dep_v = self._dep
        pay_v = self._payload
        pop = heapq.heappop
        while lheap:
            l0 = lheap[0]
            lt = l0[0]
            if heap:
                h0 = heap[0]
                ht = h0[0]
                if lt > ht or (lt == ht and l0[1] > h0[1]):
                    break
            if until is not None and lt > until:
                return True
            eng.now = lt
            slot = pop(lheap)[2]
            if kind_v is not self._kind:  # store grew mid-drain
                kind_v = self._kind
                dep_v = self._dep
                pay_v = self._payload
            obj = objs[slot]
            objs[slot] = None  # release the ref for GC
            kind = int(kind_v[slot])
            dep = int(dep_v[slot])
            pay = int(pay_v[slot])
            self._free.append(slot)
            self.applied += 1
            apply(kind, obj, dep, pay, slot)
        return False


class Engine:
    def __init__(self):
        self.now: float = 0.0
        self._heap: List[Tuple[float, int, EventHandle, Callable, tuple]] = []
        self._seq = 0
        self._lane: Optional[BatchQueue] = None

    def attach_lane(self, lane: BatchQueue) -> None:
        assert self._lane is None, "one calendar lane per engine"
        self._lane = lane

    def at(self, t: float, fn: Callable, *args) -> EventHandle:
        assert t >= self.now - 1e-9, (t, self.now)
        h = EventHandle()
        heapq.heappush(self._heap, (t, self._seq, h, fn, args))
        self._seq += 1
        return h

    def after(self, delay: float, fn: Callable, *args) -> EventHandle:
        return self.at(self.now + max(delay, 0.0), fn, *args)

    def run(self, until: Optional[float] = None,
            stop: Optional[Callable[[], bool]] = None) -> None:
        if self._lane is not None:
            return self._run_with_lane(until, stop)
        while self._heap:
            if stop is not None and stop():
                return
            item = heapq.heappop(self._heap)
            t, _, h, fn, args = item
            if h.cancelled:
                continue
            if until is not None and t > until:
                # Put it back *unchanged*; the caller may resume later.
                # Re-pushing with a fresh seq would demote the deferred
                # event behind same-timestamp events already in (or later
                # added to) the heap — the ordering regression pinned by
                # tests/test_engine.py.
                heapq.heappush(self._heap, item)
                self.now = until
                return
            self.now = t
            fn(*args)
        if until is not None:
            self.now = until

    def _run_with_lane(self, until: Optional[float],
                       stop: Optional[Callable[[], bool]]) -> None:
        """Heap loop merged with the calendar lane: drain every lane
        record due before the heap head, then process one heap event.
        ``stop`` is checked per heap event only — lane records cannot
        flip it (see the BatchQueue contract), and the lane flushes its
        deferred write-through on every drain exit, so no flush is
        needed on the return paths here."""
        heap = self._heap
        lane = self._lane
        lheap = lane._heap
        while heap or lheap:
            if stop is not None and stop():
                return
            if lheap and lane.drain(heap, until):
                self.now = until
                return
            if not heap:
                continue
            item = heapq.heappop(heap)
            t, _, h, fn, args = item
            if h.cancelled:
                continue
            if until is not None and t > until:
                heapq.heappush(heap, item)  # unchanged: seq preserved
                self.now = until
                return
            self.now = t
            fn(*args)
        if until is not None:
            self.now = until
