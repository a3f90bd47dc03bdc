"""Flight recorder: typed structured-numpy trace segments (DESIGN.md §18).

One record schema, two worlds: the simulator and the live runtime emit
the same fixed-width records — speculation verdicts with their Eq. 1–4
inputs at decision time, attempt lifecycle, drain brackets, fair-net
flow events, fault injections, rollbacks — into a
:class:`TraceRecorder`. The recorder follows the ``BatchQueue``
idiom: a numeric rail of structured-numpy records plus a parallel
python object rail for the few kinds that carry an object (policy
actions for lazy ``repr``, attempt ids for lifecycle pairing).

Cost discipline:

- **Disabled** — every emit site is guarded by one attribute test
  (``if obs is not None``); no recorder, no allocation, no call.
- **Enabled** — an emit is one tuple store into a preallocated segment.
  Memory is bounded: when ``capacity`` records are exceeded the oldest
  *segment* is dropped whole (and counted in :attr:`dropped`), so a
  10 000-node run records the recent window instead of growing without
  bound.

Determinism contract: ``time`` comes from the injected ``time_fn`` (the
engine clock in the sim, ``Clock.time`` in the runtime); ``seq`` is the
recorder's own monotonic counter — it deliberately does NOT draw from
the engine's event counter, which would perturb heap tie-breaking and
break the obs-on ≡ obs-off byte-identity gate (tests/test_obs.py).
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Iterator, List, Optional, Tuple

import numpy as np

# -- record kinds (0 stays invalid, BatchQueue convention) ----------------
K_ACTION = 1            # policy action; o = action object, a = node idx
K_DETECT = 2            # node declared failed; a = node idx, b = 1 if
#                         policy-marked (Eq. 4 / MarkNodeFailed), 0 if
#                         liveness-expiry declared
K_GLANCE_SPATIAL = 3    # Eq. 1 verdict; a = node, f0 = P_i, f1 = mean P,
#                         f2 = sigma threshold, f3 = streak
K_GLANCE_TEMPORAL = 4   # Eq. 2/3 verdict; a = node, f0 = zeta_now,
#                         f1 = zeta_prev, f2 = delta peak, f3 = dt
K_GLANCE_FAIL = 5       # Eq. 4 verdict; a = node, f0 = silent seconds,
#                         f1 = threshold_i, f2 = margin
K_THRESH = 6            # Eq. 4 adaptation; a = node, f0 = new threshold,
#                         f1 = outage length
K_LATE = 7              # LATE victim; a = task row/idx, f0 = rho,
#                         f1 = rho threshold, f2 = est_remaining
K_ATT_START = 8         # o = attempt id; a = node idx, b = flag bits
K_ATT_END = 9           # o = attempt id; a = node idx, b = state code,
#                         f0 = start time, f1 = progress/work,
#                         f2 = 1.0 if speculative
K_DRAIN = 10            # lane drain; b = records applied, f0 = t_begin
K_FLOW_OPEN = 11        # a = src node idx, b = dst node idx, f0 = rate
K_FLOW_CLOSE = 12       # a = src node idx, b = dst node idx
K_FLOW_BULK = 13        # staged bulk rebuild; a = opens, b = closes
K_FAULT = 14            # injected fault fired; a = victim node idx
#                         (-1 if not node-targeted), b = fault code,
#                         f0 = script x, f1 = script y
K_ROLLBACK = 15         # a = node idx / -1, b = retry count
K_CHECKPOINT = 16       # b = step
K_RAMP = 17             # collective ramp; a = task idx, b = n backups,
#                         f0 = rnd draw, f1 = neighborhood budget
K_DISPATCH = 18         # container grant; a = node idx,
#                         b = bit0 speculative | bit1 rollback
K_FETCH_FAIL = 19       # fetch failure cycle burned; a = node idx
K_BUDGET = 20           # cluster-wide speculation-budget tick;
#                         a = slots in use after admission, b = capacity,
#                         f0 = candidates proposed, f1 = admitted,
#                         f2 = denied this tick
K_PREDICT = 21          # learned-policy straggler score; o = task id,
#                         a = node idx, b = 1 if admitted for backup,
#                         f0 = sigmoid score, f1 = decision threshold

KIND_NAMES = {
    K_ACTION: "action", K_DETECT: "detect",
    K_GLANCE_SPATIAL: "glance_spatial", K_GLANCE_TEMPORAL: "glance_temporal",
    K_GLANCE_FAIL: "glance_fail", K_THRESH: "eq4_adapt", K_LATE: "late",
    K_ATT_START: "attempt_start", K_ATT_END: "attempt_end",
    K_DRAIN: "drain", K_FLOW_OPEN: "flow_open", K_FLOW_CLOSE: "flow_close",
    K_FLOW_BULK: "flow_bulk", K_FAULT: "fault", K_ROLLBACK: "rollback",
    K_CHECKPOINT: "checkpoint", K_RAMP: "ramp", K_DISPATCH: "dispatch",
    K_FETCH_FAIL: "fetch_fail", K_BUDGET: "budget", K_PREDICT: "predict",
}

# action codes for K_ACTION.b / attempt-end state codes for K_ATT_END.b
ACT_MARK_FAILED = 1
ACT_SPECULATE = 2
ACT_KILL = 3

END_COMPLETED = 1
END_FAILED = 2
END_KILLED = 3

# fault kind → stable code (union of the sim and chaos vocabularies;
# keep in sync with repro_torch.sim.faults.SCRIPT_KINDS / runtime.chaos)
FAULT_CODES = {
    "crash": 1, "crash_restore": 2, "slow": 3, "hb": 4, "mof": 5,
    "disk": 6, "degrade": 7, "cut": 8, "part": 9, "hang": 10,
    "delay_hb": 11, "drop": 12, "dup": 13, "reorder": 14,
}
# fault codes whose victim is a node (scorecard ground-truth set)
NODE_FAULT_CODES = frozenset(
    FAULT_CODES[k] for k in
    ("crash", "crash_restore", "slow", "hb", "hang", "delay_hb"))

TRACE_DTYPE = np.dtype([
    ("kind", np.int16),
    ("time", np.float64),
    ("seq", np.int64),
    ("a", np.int32),
    ("b", np.int32),
    ("o", np.int32),       # index into the segment's object rail; -1 = none
    ("f0", np.float64),
    ("f1", np.float64),
    ("f2", np.float64),
    ("f3", np.float64),
])


class _Segment:
    __slots__ = ("recs", "n", "objs")

    def __init__(self, size: int):
        self.recs = np.zeros(size, dtype=TRACE_DTYPE)
        self.n = 0
        self.objs: List[Any] = []


class TraceRecorder:
    """Bounded, low-overhead structured-record trace buffer."""

    __slots__ = ("time_fn", "segment_size", "capacity", "dropped",
                 "_segs", "_seq", "_lock")

    def __init__(self, time_fn: Optional[Callable[[], float]] = None, *,
                 capacity: int = 262_144, segment_size: int = 8_192,
                 thread_safe: bool = False):
        self.time_fn = time_fn if time_fn is not None else (lambda: 0.0)
        self.segment_size = int(segment_size)
        self.capacity = max(int(capacity), self.segment_size)
        self.dropped = 0
        self._segs: List[_Segment] = [_Segment(self.segment_size)]
        self._seq = 0
        self._lock = threading.Lock() if thread_safe else None

    # -- hot path ---------------------------------------------------------
    def emit(self, kind: int, a: int = 0, b: int = 0,
             f0: float = 0.0, f1: float = 0.0, f2: float = 0.0,
             f3: float = 0.0, obj: Any = None) -> None:
        if self._lock is not None:
            with self._lock:
                self._emit(kind, a, b, f0, f1, f2, f3, obj)
        else:
            self._emit(kind, a, b, f0, f1, f2, f3, obj)

    def _emit(self, kind, a, b, f0, f1, f2, f3, obj) -> None:
        seg = self._segs[-1]
        if seg.n >= self.segment_size:
            seg = self._grow()
        o = -1
        if obj is not None:
            o = len(seg.objs)
            seg.objs.append(obj)
        seg.recs[seg.n] = (kind, self.time_fn(), self._seq, a, b, o,
                           f0, f1, f2, f3)
        seg.n += 1
        self._seq += 1

    def _grow(self) -> _Segment:
        if len(self._segs) * self.segment_size >= self.capacity:
            victim = self._segs.pop(0)     # drop-oldest, whole segment
            self.dropped += victim.n
        seg = _Segment(self.segment_size)
        self._segs.append(seg)
        return seg

    # -- reads ------------------------------------------------------------
    def __len__(self) -> int:
        return sum(s.n for s in self._segs)

    def records(self) -> np.ndarray:
        """All retained records, oldest first, as one structured array."""
        parts = [s.recs[:s.n] for s in self._segs if s.n]
        if not parts:
            return np.zeros(0, dtype=TRACE_DTYPE)
        return np.concatenate(parts)

    def by_kind(self, kind: int) -> np.ndarray:
        recs = self.records()
        return recs[recs["kind"] == kind]

    def iter_with_objs(self, kind: Optional[int] = None
                       ) -> Iterator[Tuple[np.void, Any]]:
        """Yield ``(record, obj-or-None)`` pairs in emission order."""
        for seg in self._segs:
            recs = seg.recs
            for i in range(seg.n):
                r = recs[i]
                if kind is not None and int(r["kind"]) != kind:
                    continue
                o = int(r["o"])
                yield r, (seg.objs[o] if o >= 0 else None)

    def actions(self) -> Iterator[Tuple[float, Any]]:
        """``(time, action object)`` pairs for every K_ACTION record —
        the lazy-repr backing of ``Simulation.action_trace``."""
        for r, obj in self.iter_with_objs(K_ACTION):
            yield float(r["time"]), obj

    def counts(self) -> dict:
        recs = self.records()
        kinds, n = np.unique(recs["kind"], return_counts=True)
        return {KIND_NAMES.get(int(k), str(int(k))): int(c)
                for k, c in zip(kinds, n)}

    def clear(self) -> None:
        self._segs = [_Segment(self.segment_size)]
        self.dropped = 0
        self._seq = 0
