"""Host daemons: thread-simulated hosts with a real control plane, copied
from the reference's ``repro/runtime/hosts.py``.

Each ``HostDaemon`` executes assigned *map work* — microbatch gradient
production for a data shard — and streams results + progress reports to
the coordinator. Fault injection mirrors the simulator's vocabulary:
``freeze()`` (crash: heartbeats and compute stop), ``hang()`` (the liar
node: compute stops but heartbeats keep flowing), ``slow(factor)``
(straggler), ``mute(duration)`` (transient network outage: compute
continues, heartbeats vanish). Message-plane faults (drop / duplicate /
delay / reorder on the way to the coordinator) are injected one layer
up, by ``repro_torch.runtime.chaos`` wrapping the out-queue and the heartbeat
callback (DESIGN.md §16.3).

Delivery is at-least-once: the coordinator redelivers unacknowledged
``WorkItem``s with backoff, so the daemon acks every item and keeps a
seen-set to make redelivery idempotent (§16.5). All time flows through
an injected :class:`repro_torch.runtime.clock.Clock`.

The gradient computation itself runs in-process: every host thread
issues its work to the one device of the process (the CUDA card, or the
CPU in tests), and the threads share one parameter object that none of
them writes. What is REAL here is the control plane the paper is about:
heartbeats, progress logs, speculative reassignment, rollback.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Dict, Optional

from repro_torch.data.pipeline import DataState
from repro_torch.runtime.clock import Clock, SystemClock


@dataclasses.dataclass
class WorkItem:
    """One map task: produce grads for microbatches [mb_start, mb_end) of
    ``shard`` at ``step``. ``data_state`` pins the exact batches."""

    step: int
    task_id: str
    shard_id: int
    mb_start: int
    mb_end: int
    data_state: DataState
    attempt_id: str = ""
    speculative: bool = False


@dataclasses.dataclass
class GradMessage:
    """One microbatch's contribution, streamed eagerly (the 'MOF' lives on
    the consumer side the moment it exists — eager shuffle)."""

    step: int
    task_id: str
    attempt_id: str
    shard_id: int
    mb_index: int
    grads: Any
    metrics: Dict[str, float]
    host_id: str


@dataclasses.dataclass
class ProgressMessage:
    step: int
    task_id: str
    attempt_id: str
    host_id: str
    mb_done: int
    mb_total: int
    data_state: DataState
    done: bool = False


@dataclasses.dataclass
class AckMessage:
    """Work-item receipt: the coordinator stops redelivering on this.
    Acks themselves ride the (chaos-faultable) out-queue, so a dropped
    ack triggers a redelivery the seen-set then swallows — idempotent in
    both directions."""

    step: int
    attempt_id: str
    host_id: str


class HostDaemon(threading.Thread):
    def __init__(self, host_id: str, *, grad_fn: Callable,
                 batch_fn: Callable[[DataState], Dict[str, Any]],
                 out_queue, heartbeat: Callable[[str, float], None],
                 heartbeat_period: float = 0.05,
                 compute_delay: float = 0.0,
                 clock: Optional[Clock] = None):
        super().__init__(daemon=True, name=f"host-{host_id}")
        self.host_id = host_id
        self.grad_fn = grad_fn
        self.batch_fn = batch_fn
        self.out = out_queue
        self.heartbeat_cb = heartbeat
        self.heartbeat_period = heartbeat_period
        self.clock = clock if clock is not None else SystemClock()
        # artificial per-microbatch delay: makes tiny test models behave
        # like real work so stragglers/failures have visible timelines
        self.compute_delay = compute_delay
        self._work: "queue.Queue[Optional[WorkItem]]" = queue.Queue()
        self._params = None
        self._params_lock = threading.Lock()
        # fault state
        self._frozen = threading.Event()
        self._hung = threading.Event()
        self._speed = 1.0
        self._mute_until = 0.0
        self._halt = threading.Event()
        self._cancelled: set = set()
        # at-least-once delivery: attempt ids already accepted (redelivered
        # work items are re-acked but not re-executed)
        self._seen: set = set()

    # -- control ---------------------------------------------------------
    def set_params(self, params) -> None:
        with self._params_lock:
            self._params = params

    def assign(self, item: WorkItem) -> None:
        self._work.put(item)

    def cancel(self, attempt_id: str) -> None:
        self._cancelled.add(attempt_id)

    def shutdown(self) -> None:
        self._halt.set()
        self._work.put(None)

    # -- fault injection ---------------------------------------------------
    def freeze(self) -> None:
        """Crash: no heartbeats, no compute, in-flight work lost."""
        self._frozen.set()

    def unfreeze(self) -> None:
        self._frozen.clear()

    def hang(self) -> None:
        """Livelock: compute stops but heartbeats keep flowing — the node
        that looks healthy to Eq. 4 and can only be caught by the
        progress-based assessments (Eq. 1–3 / tail-straggler)."""
        self._hung.set()

    def unhang(self) -> None:
        self._hung.clear()

    def slow(self, factor: float) -> None:
        """Straggler: microbatches take ``factor×`` longer."""
        self._speed = max(factor, 1e-3)

    def mute(self, duration: float) -> None:
        """Transient outage: heartbeats vanish, compute continues."""
        self._mute_until = self.clock.time() + duration

    @property
    def frozen(self) -> bool:
        return self._frozen.is_set()

    # -- main loop --------------------------------------------------------
    def _hb_loop(self) -> None:
        """NodeManager heartbeat thread: independent of task work (a busy
        or compiling host still heartbeats — only crash/outage silences)."""
        while not self._halt.is_set():
            now = self.clock.time()
            if not self._frozen.is_set() and now >= self._mute_until:
                self.heartbeat_cb(self.host_id, now)
            self.clock.sleep(self.heartbeat_period)

    def run(self) -> None:
        threading.Thread(target=self._hb_loop, daemon=True,
                         name=f"hb-{self.host_id}").start()
        while not self._halt.is_set():
            try:
                item = self._work.get(timeout=self.heartbeat_period)
            except queue.Empty:
                continue
            if item is None:
                return
            # Ack on receipt; a redelivered item is acked again but not
            # re-executed (exactly-once execution under at-least-once
            # delivery).
            first = item.attempt_id not in self._seen
            self._seen.add(item.attempt_id)
            self.out.put(AckMessage(step=item.step,
                                    attempt_id=item.attempt_id,
                                    host_id=self.host_id))
            if first:
                self._execute(item)

    def _blocked(self) -> bool:
        return self._frozen.is_set() or self._hung.is_set()

    def _execute(self, item: WorkItem) -> None:
        state = item.data_state
        for mb in range(item.mb_start, item.mb_end):
            # crash/hang = stop making progress, silently
            while self._blocked():
                if self._halt.is_set():
                    return
                time.sleep(0.002)
            if item.attempt_id in self._cancelled or self._halt.is_set():
                return
            batch = self.batch_fn(state)
            with self._params_lock:
                params = self._params
            grads, metrics = self.grad_fn(params, batch)
            delay = self.compute_delay * self._speed
            if delay > 0:
                self.clock.sleep(delay)
            if self._frozen.is_set():
                return  # crashed during compute: result lost with the host
            if self._hung.is_set():
                continue_at = mb  # hung mid-compute: result withheld
                while self._hung.is_set() and not self._frozen.is_set():
                    if self._halt.is_set() \
                            or item.attempt_id in self._cancelled:
                        return
                    time.sleep(0.002)
                if self._frozen.is_set():
                    return
                del continue_at
            state = state.advance()
            self.out.put(GradMessage(
                step=item.step, task_id=item.task_id,
                attempt_id=item.attempt_id, shard_id=item.shard_id,
                mb_index=mb, grads=grads,
                metrics={k: float(v) for k, v in metrics.items()},
                host_id=self.host_id))
            self.out.put(ProgressMessage(
                step=item.step, task_id=item.task_id,
                attempt_id=item.attempt_id, host_id=self.host_id,
                mb_done=mb + 1 - item.mb_start,
                mb_total=item.mb_end - item.mb_start,
                data_state=state,
                done=(mb == item.mb_end - 1)))
