"""Chaos fault plane for the live runtime (DESIGN.md §16.3), copied from
the reference's ``repro/runtime/chaos.py``.

One declarative fault script, two worlds: the same plain tuples
``(kind, idx, x, y)`` that ``repro_torch.sim.faults.apply_script`` arms against
the discrete-event simulator are interpreted here against *real threads*
— the :class:`ChaosController` wraps each ``HostDaemon``'s channels to
the coordinator and injects the paper's fault vocabulary with live
timing:

========  ==========================================================
kind      runtime effect (victim = ``hosts[idx % n]``)
========  ==========================================================
crash     ``host.freeze()`` — heartbeats and compute stop, for good
crash_restore  freeze, then ``unfreeze()`` after the scaled duration
hang      ``host.hang()`` — compute stops, heartbeats keep flowing
slow      ``host.slow(f)`` — microbatches take 1/(0.02+0.06y)× longer
hb        ``host.mute(dur)`` — heartbeats vanish, compute continues
delay_hb  heartbeats delivered late (original timestamps) for a window
drop      outbound Grad/Progress/Ack messages silently discarded
dup       outbound messages delivered twice
reorder   adjacent outbound messages pairwise swapped
cut       transient link cut: outbound messages + heartbeats dropped
          AND inbound work-item delivery dropped (exercises the
          coordinator's ack/retry path), for a window
degrade   → slow (no rack switches in the thread runtime; §16.4)
part      → cut       (single-host partition)
mof       → drop      (a lost consumer-side MOF is a lost message)
disk      → hang for a short window (attempt stalls, host healthy)
========  ==========================================================

``x`` maps to an absolute fire time ``t0 + x*horizon``; ``y`` scales
durations/magnitudes. All randomness (none today — scripts are fully
deterministic) would come from the seeded RNG, so a script replays
identically given the same clock behaviour.

The controller never touches payloads: a "duplicated" GradMessage is the
same object delivered twice, which the coordinator's first-writer-wins
dedup must (and does) swallow — that is the exactly-once invariant the
chaos matrix in ``tests/test_runtime.py`` pins down.
"""
from __future__ import annotations

import heapq
import itertools
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.trace import FAULT_CODES, K_FAULT
from repro_torch.runtime.clock import Clock
from repro_torch.runtime.hosts import AckMessage, GradMessage, ProgressMessage

Script = Sequence[Tuple[str, int, float, float]]

# Named pinned scripts: the chaos corpus used by tests/test_runtime.py,
# examples/serve.py --chaos <name>, and benchmarks/perf_runtime.py. Keep
# in sync with SCRIPT_KINDS in repro_torch/sim/faults.py.
PINNED_SCRIPTS: Dict[str, List[Tuple[str, int, float, float]]] = {
    "crash": [("crash", 1, 0.2, 0.0)],
    "crash_restore": [("crash_restore", 1, 0.15, 0.3)],
    "hang": [("hang", 2, 0.2, 0.4)],
    "slow": [("slow", 2, 0.1, 0.5)],
    "hb_outage": [("hb", 1, 0.15, 0.3)],
    "delay_hb": [("delay_hb", 1, 0.1, 0.5)],
    "drop": [("drop", 1, 0.1, 0.5)],
    "dup": [("dup", 0, 0.05, 0.9)],
    "reorder": [("reorder", 3, 0.05, 0.8)],
    "cut": [("cut", 1, 0.15, 0.35)],
    "crash_plus_drop": [("crash", 1, 0.25, 0.0), ("drop", 2, 0.1, 0.4)],
}


def parse_script(text: str) -> List[Tuple[str, int, float, float]]:
    """``--chaos`` argument: a pinned-script name, or inline steps
    ``kind:idx:x:y[,kind:idx:x:y...]``."""
    if text in PINNED_SCRIPTS:
        return list(PINNED_SCRIPTS[text])
    steps = []
    for part in text.split(","):
        kind, idx, x, y = part.split(":")
        steps.append((kind, int(idx), float(x), float(y)))
    return steps


class _HostState:
    """Active fault windows for one host (virtual-time deadlines)."""

    __slots__ = ("drop_until", "dup_until", "reorder_until", "cut_until",
                 "hb_delay_until", "hb_delay", "held", "lock")

    def __init__(self) -> None:
        self.drop_until = 0.0
        self.dup_until = 0.0
        self.reorder_until = 0.0
        self.cut_until = 0.0
        self.hb_delay_until = 0.0
        self.hb_delay = 0.0
        self.held = None  # reorder buffer: at most one message in flight
        self.lock = threading.Lock()


class _OutTap:
    """Queue facade interposed between a host and the coordinator inbox."""

    def __init__(self, ctrl: "ChaosController", host_id: str, down) -> None:
        self._ctrl = ctrl
        self._hid = host_id
        self._down = down

    def put(self, msg) -> None:
        self._ctrl._on_out(self._hid, msg, self._down)


class ChaosController:
    """Interprets a declarative fault script against live host threads."""

    def __init__(self, script: Script, *, horizon: float = 4.0,
                 seed: int = 0, defer_arm: bool = False) -> None:
        self.script = [tuple(s) for s in script]
        self.horizon = float(horizon)
        self.defer_arm = bool(defer_arm)
        # Optional flight recorder (repro_torch.obs): one K_FAULT ground-truth
        # record per script step, emitted at fire time from THIS
        # controller's scheduler thread — pass a recorder built with
        # ``thread_safe=True``. The Coordinator auto-wires its own ``obs``
        # here when none was set.
        self.obs = None
        self._armed = False
        self.rng = random.Random(seed)
        self.stats: Dict[str, int] = {}
        self._states: Dict[str, _HostState] = {}
        self._hosts: Dict[str, object] = {}
        self._clock: Optional[Clock] = None
        self._t0 = 0.0
        self._events: list = []  # heap of (virtual time, seq, fn)
        self._seq = itertools.count()
        self._ev_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- wiring (called by the Coordinator while spawning hosts) ---------
    def wrap_out(self, host_id: str, down_queue):
        self._states.setdefault(host_id, _HostState())
        return _OutTap(self, host_id, down_queue)

    def wrap_heartbeat(self, host_id: str,
                       cb: Callable[[str, float], None]):
        self._states.setdefault(host_id, _HostState())

        def wrapped(hid: str, ts: float) -> None:
            st = self._states[hid]
            now = self._now()
            if st.cut_until > now:
                self._bump("hb_dropped")
                return
            if st.hb_delay_until > now and st.hb_delay > 0:
                # delivered late, with the ORIGINAL timestamp — the
                # coordinator's monotonic max() guard must absorb the
                # resulting reordering
                self._bump("hb_delayed")
                self._schedule(now + st.hb_delay, lambda: cb(hid, ts))
                return
            cb(hid, ts)

        return wrapped

    def deliver_assign(self, host, item) -> bool:
        """Coordinator→host work-item delivery; a cut link eats it (the
        unacked send is retried with backoff — §16.5). Returns whether
        the item was actually delivered."""
        st = self._states.get(host.host_id)
        if st is not None and st.cut_until > self._now():
            self._bump("assign_dropped")
            return False
        host.assign(item)
        return True

    def arm(self, hosts: Dict[str, object], clock: Clock) -> None:
        """Wire up hosts/clock; unless ``defer_arm``, compile the script
        into timed events and start the scheduler immediately."""
        self._hosts = dict(hosts)
        self._clock = clock
        if not self.defer_arm:
            self.release()

    def release(self) -> None:
        """Compile the script against *now* (``t0 = clock.time()``) and
        start the scheduler. Called automatically from :meth:`arm` unless
        ``defer_arm=True`` — the load harness defers so JIT warm-up steps
        run fault-free and the fault lands at a known measured instant."""
        if self._armed:
            return
        assert self._clock is not None, "release() before arm()"
        self._armed = True
        self._t0 = self._clock.time()
        ids = sorted(self._hosts)
        for kind, idx, x, y in self.script:
            hid = ids[idx % len(ids)]
            self._compile(kind, hid, float(x), float(y),
                          pos=idx % len(ids))
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="chaos-sched")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        # flush any reorder-held message so nothing is silently lost
        for hid, st in self._states.items():
            with st.lock:
                held, st.held = st.held, None
            if held is not None:
                self._bump("reorder_flushed")

    # -- script compilation ----------------------------------------------
    def _compile(self, kind: str, hid: str, x: float, y: float,
                 pos: int = -1) -> None:
        at = self._t0 + x * self.horizon
        dur = (0.15 + 0.5 * y) * self.horizon
        host = self._hosts[hid]
        st = self._states.setdefault(hid, _HostState())

        def emit_fault() -> None:
            # ground truth for the speculation scorecard (§18.4): reads
            # self.obs at fire time so late wiring still records
            rec = self.obs
            if rec is not None:
                rec.emit(K_FAULT, a=pos, b=FAULT_CODES.get(kind, 0),
                         f0=x, f1=y, obj=hid)

        self._schedule(at, emit_fault)

        def window(attr: str) -> None:
            # windows only ever extend (overlap unions, like the sim)
            setattr(st, attr, max(getattr(st, attr), at + dur))

        if kind == "crash":
            self._schedule(at, host.freeze)
        elif kind == "crash_restore":
            self._schedule(at, host.freeze)
            self._schedule(at + dur, host.unfreeze)
        elif kind in ("hang", "disk"):
            d = dur if kind == "hang" else 0.35 * self.horizon
            self._schedule(at, host.hang)
            self._schedule(at + d, host.unhang)
        elif kind in ("slow", "degrade"):
            factor = 1.0 / (0.02 + 0.06 * y)  # sim speed -> delay multiple
            if kind == "degrade":
                factor = min(factor, 8.0)
            self._schedule(at, lambda: host.slow(factor))
            self._schedule(at + dur, lambda: host.slow(1.0))
        elif kind == "hb":
            self._schedule(at, lambda: host.mute(dur))
        elif kind == "delay_hb":
            delay = (0.05 + 0.25 * y) * self.horizon

            def start_delay() -> None:
                st.hb_delay = max(st.hb_delay, delay)
                window("hb_delay_until")

            self._schedule(at, start_delay)
        elif kind in ("drop", "mof"):
            self._schedule(at, lambda: window("drop_until"))
        elif kind == "dup":
            self._schedule(at, lambda: window("dup_until"))
        elif kind == "reorder":
            self._schedule(at, lambda: window("reorder_until"))
            # flush a straggler held past the window's end
            self._schedule(at + dur + 1e-6, lambda: self._flush_held(hid))
        elif kind in ("cut", "part"):
            self._schedule(at, lambda: window("cut_until"))
        else:  # pragma: no cover - corpus bug guard
            raise ValueError(f"unknown chaos kind: {kind}")

    # -- message-plane interposition --------------------------------------
    def _on_out(self, hid: str, msg, down) -> None:
        if not isinstance(msg, (GradMessage, ProgressMessage, AckMessage)):
            down.put(msg)
            return
        st = self._states[hid]
        now = self._now()
        if st.cut_until > now or st.drop_until > now:
            self._bump("msg_dropped")
            return
        if st.reorder_until > now:
            with st.lock:
                if st.held is None:
                    st.held = msg
                    return
                held, st.held = st.held, None
            self._bump("msg_reordered")
            down.put(msg)    # later message first...
            down.put(held)   # ...then the earlier one
            return
        if st.dup_until > now:
            self._bump("msg_duplicated")
            down.put(msg)
            down.put(msg)
            return
        with st.lock:
            held, st.held = st.held, None
        if held is not None:  # reorder window just closed
            down.put(held)
        down.put(msg)

    def _flush_held(self, hid: str) -> None:
        st = self._states[hid]
        with st.lock:
            held, st.held = st.held, None
        if held is not None:
            self._bump("reorder_flushed")
            # downstream queue is the coordinator inbox; every tap of a
            # host shares it, so any tap's down works — use none: deliver
            # via the host's out queue is gone here, so stash on coord
            self._late_deliver(held)

    def _late_deliver(self, msg) -> None:
        # the coordinator inbox is shared across hosts; grab it from any
        # armed host's out tap
        for host in self._hosts.values():
            out = getattr(host, "out", None)
            if isinstance(out, _OutTap):
                out._down.put(msg)
                return

    # -- scheduler ---------------------------------------------------------
    def _schedule(self, at: float, fn: Callable[[], None]) -> None:
        with self._ev_lock:
            heapq.heappush(self._events, (at, next(self._seq), fn))

    def _loop(self) -> None:
        while not self._stop.is_set():
            with self._ev_lock:
                head = self._events[0] if self._events else None
            if head is None:
                if not self._stop.is_set():
                    time.sleep(0.005)
                    with self._ev_lock:
                        empty = not self._events
                    if empty:
                        continue
                continue
            now = self._now()
            at, _, fn = head
            if now + 1e-9 >= at:
                with self._ev_lock:
                    heapq.heappop(self._events)
                try:
                    fn()
                    self._bump("events_fired")
                except Exception:  # pragma: no cover - fault hooks are
                    pass           # best-effort; never kill the scheduler
            else:
                # clock-aware wait: under FakeClock this parks a deadline
                # the auto-advancer can jump to
                assert self._clock is not None
                self._clock.sleep(min(at - now, 0.05 * self.horizon))

    # -- helpers -----------------------------------------------------------
    def _now(self) -> float:
        return self._clock.time() if self._clock is not None else 0.0

    def _bump(self, key: str) -> None:
        self.stats[key] = self.stats.get(key, 0) + 1
