"""Injectable time source for the live runtime (DESIGN.md §16.2), copied
from the reference's ``repro/runtime/clock.py``.

Every timestamp, timeout and sleep in ``repro_torch.runtime`` flows through a
:class:`Clock`, so the chaos tests can compress hours of failure-detection
timelines into milliseconds of wall clock and — more importantly — so no
test assertion ever races the scheduler against a real ``time.sleep``.

- :class:`SystemClock` — ``time.time``/``time.sleep``; the default, used
  by the load harness (honest p50/p99 latencies) and the examples.
- :class:`FakeClock` — virtual time. ``sleep`` blocks the calling thread
  until virtual now reaches its deadline; time moves only via
  :meth:`FakeClock.advance` or the auto-advancer, which jumps to the
  earliest pending deadline once the sleeper set has settled (no
  registrations/wake-ups for ``settle`` real seconds). Threads doing real
  work (a jitted grad computation) are simply not sleepers: virtual time
  waits for nobody but also never deadlocks on them, because at least the
  host heartbeat loops are always parked on a deadline.

The coordinator's policy thresholds (heartbeat silence, restart timeout,
backoff schedules, step deadlines) are all compared in *clock* time, so a
``FakeClock`` run exercises exactly the same detection logic as a real
deployment — just faster and reproducibly.
"""
from __future__ import annotations

import itertools
import threading
import time


class Clock:
    """Time-source protocol for the runtime."""

    def time(self) -> float:  # pragma: no cover - protocol
        raise NotImplementedError

    def sleep(self, dt: float) -> None:  # pragma: no cover - protocol
        raise NotImplementedError


class SystemClock(Clock):
    def time(self) -> float:
        return time.time()

    def sleep(self, dt: float) -> None:
        if dt > 0:
            time.sleep(dt)


class FakeClock(Clock):
    """Deterministically advanceable virtual clock for chaos tests.

    ``auto_advance=True`` starts a daemon that, whenever at least one
    thread is parked in :meth:`sleep` and nothing has changed for
    ``settle`` real seconds, jumps virtual time to the earliest pending
    deadline. A whole simulated failure-detection window (say a 6 s
    restart timeout) then elapses in a few milliseconds of wall time.
    """

    def __init__(self, start: float = 1000.0, *, auto_advance: bool = False,
                 settle: float = 0.002, max_real_wait: float = 0.05):
        self._now = float(start)
        self._cond = threading.Condition()
        self._waiters: dict = {}          # waiter id -> virtual deadline
        self._ids = itertools.count()
        self._activity = 0                # bumped on any state change
        self._settle = settle
        self._max_real_wait = max_real_wait
        self._stop = threading.Event()
        self._auto = None
        if auto_advance:
            self._auto = threading.Thread(target=self._auto_loop,
                                          daemon=True, name="fakeclock")
            self._auto.start()

    # -- Clock protocol --------------------------------------------------
    def time(self) -> float:
        with self._cond:
            return self._now

    def sleep(self, dt: float) -> None:
        if dt <= 0:
            time.sleep(0)  # yield
            return
        with self._cond:
            deadline = self._now + dt
            wid = next(self._ids)
            self._waiters[wid] = deadline
            self._activity += 1
            self._cond.notify_all()
            try:
                while self._now < deadline and not self._stop.is_set():
                    # Real-time cap: a FakeClock without an advancer (or a
                    # shutdown mid-sleep) must never hard-hang a daemon.
                    self._cond.wait(timeout=self._max_real_wait)
            finally:
                del self._waiters[wid]
                self._activity += 1
                self._cond.notify_all()

    # -- test control ----------------------------------------------------
    def advance(self, dt: float) -> None:
        with self._cond:
            self._now += float(dt)
            self._activity += 1
            self._cond.notify_all()

    def advance_to(self, t: float) -> None:
        with self._cond:
            if t > self._now:
                self._now = float(t)
                self._activity += 1
                self._cond.notify_all()

    def close(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()

    # -- auto-advancer ---------------------------------------------------
    def _auto_loop(self) -> None:
        while not self._stop.is_set():
            with self._cond:
                snap = self._activity
                waiters = bool(self._waiters)
            time.sleep(self._settle)
            with self._cond:
                if (waiters and self._activity == snap
                        and self._waiters):
                    target = min(self._waiters.values())
                    if target > self._now:
                        self._now = target
                        self._activity += 1
                        self._cond.notify_all()
