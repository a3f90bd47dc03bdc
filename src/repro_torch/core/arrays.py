"""Columnar (struct-of-arrays) cluster snapshots — the vectorized
assessment hot path (DESIGN.md §11).

The per-object ``ClusterSnapshot`` rebuilds every ``TaskView``/``AttemptView``
dataclass on each speculator tick: O(tasks × attempts) allocation and
interpretation per assessment, which caps the simulator near the paper's
21-node testbed. ``ArraySnapshot`` instead keeps one numpy column per
attempt attribute, maintained *incrementally* by the substrate on attempt
start/progress/finish events, so an assessment tick is a handful of
vectorized reductions regardless of cluster size.

Equivalence contract (DESIGN.md §11.3): every query here replicates the
reference per-object arithmetic **operation for operation** — same clip
constants, same operand order, same accumulation order (see
:meth:`order`) — so the vectorized policies emit bit-identical action
sequences. ``tests/test_columnar.py`` enforces this on seeded runs.

Row lifecycle: one row per execution attempt, append-only; rows of
completed jobs are deactivated and physically dropped by opportunistic
compaction (stress workloads submit hundreds of jobs). Substrate objects
that own a row expose a writable ``row`` attribute which compaction
re-targets.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.types import AttemptState, TaskKind, TaskState

__all__ = [
    "ArraySnapshot",
    "DeviceColumns",
    "SHUFFLE_FRACTION",
    "ASTATE",
    "TSTATE",
    "KIND",
    "snapshot_from_state",
    "snapshot_state",
]

# Reduce ProgressScore split: 1/3 shuffle, 2/3 sort+reduce (YARN's phases).
# Single source of truth — the simulator imports this constant.
SHUFFLE_FRACTION = 1.0 / 3.0

# Compact integer codes for the enum columns.
ASTATE = {
    AttemptState.RUNNING: 0,
    AttemptState.COMPLETED: 1,
    AttemptState.FAILED: 2,
    AttemptState.KILLED: 3,
}
TSTATE = {
    TaskState.PENDING: 0,
    TaskState.RUNNING: 1,
    TaskState.COMPLETED: 2,
    TaskState.FAILED: 3,
}
KIND = {TaskKind.MAP: 0, TaskKind.REDUCE: 1}

A_RUNNING = ASTATE[AttemptState.RUNNING]
A_COMPLETED = ASTATE[AttemptState.COMPLETED]
T_RUNNING = TSTATE[TaskState.RUNNING]
T_COMPLETED = TSTATE[TaskState.COMPLETED]

# Attempts-per-task fits comfortably below this; the canonical sort key is
# ``task_order * _KEY_STRIDE + attempt_seq``.
_KEY_STRIDE = 1 << 20

_INIT_CAP = 256


class ArraySnapshot:
    """Incrementally-maintained numpy columns over attempts and nodes."""

    def __init__(self, node_ids, n_containers: int = 8):
        self.node_ids: List[str] = list(node_ids)
        self.node_index: Dict[str, int] = {
            n: i for i, n in enumerate(self.node_ids)}
        n = len(self.node_ids)
        # --- node columns -------------------------------------------------
        self.node_hb = np.zeros(n)
        self.node_speed = np.ones(n)
        self.node_free = np.full(n, n_containers, dtype=np.int32)
        self.node_total = np.full(n, n_containers, dtype=np.int32)
        self.node_marked = np.zeros(n, dtype=bool)
        # Liveness + heartbeat-suppression mirrors: the per-second RM
        # tick is one vectorized mask over these instead of a python
        # loop over every SimNode (DESIGN.md §17.5).
        self.node_alive = np.ones(n, dtype=bool)
        self.node_supp = np.zeros(n)
        # --- network columns (DESIGN.md §15) -----------------------------
        # Active shuffle flows per node, link liveness, rack membership
        # and per-rack uplink flow/degradation state. ``init_net`` aliases
        # these to the network model's own arrays, so the model's single
        # write-through store serves both (verified against a recount by
        # ``Simulation.verify_network``). The placeholders below keep
        # standalone snapshots (tests, sweeps) self-contained.
        self.node_flows = np.zeros(n, dtype=np.int32)
        self.node_link_up = np.ones(n, dtype=bool)
        self.node_rack = np.zeros(n, dtype=np.int32)
        self.rack_flows = np.zeros(1, dtype=np.int32)
        self.rack_factor = np.ones(1)
        # --- job registry -------------------------------------------------
        self.job_index: Dict[str, int] = {}
        self.job_ids: List[str] = []
        self._job_active: List[bool] = []
        self._job_tasks: List[int] = []
        # --- attempt columns ----------------------------------------------
        self.n = 0
        cap = _INIT_CAP
        self.a_state = np.zeros(cap, dtype=np.int8)
        self.t_state = np.zeros(cap, dtype=np.int8)
        self.kind = np.zeros(cap, dtype=np.int8)
        self.job = np.zeros(cap, dtype=np.int32)
        self.node = np.zeros(cap, dtype=np.int32)
        self.spec = np.zeros(cap, dtype=bool)
        self.start = np.zeros(cap)
        self.work_done = np.zeros(cap)
        self.work_total = np.ones(cap)
        self.last_sync = np.zeros(cap)
        self.fetched = np.zeros(cap, dtype=np.int32)
        self.deps = np.ones(cap, dtype=np.int32)
        self.compute = np.zeros(cap, dtype=bool)
        self.active = np.zeros(cap, dtype=bool)
        self.skey = np.zeros(cap, dtype=np.int64)
        # Shuffle-health columns (reduce attempts; write-through from the
        # shuffle engine): producers ready-but-unfetched, transfers in
        # flight, failure cycles burning. Together with ``fetched`` they
        # partition the not-yet-waiting dependencies, keeping fetch-health
        # signals vectorized for the policies.
        self.sh_ready = np.zeros(cap, dtype=np.int32)
        self.sh_inflight = np.zeros(cap, dtype=np.int32)
        self.sh_fail = np.zeros(cap, dtype=np.int32)
        self._float_cols = ["start", "work_done", "work_total", "last_sync"]
        self._int_like_cols = ["a_state", "t_state", "kind", "job", "node",
                               "spec", "fetched", "deps", "compute",
                               "active", "skey", "sh_ready", "sh_inflight",
                               "sh_fail"]
        # Parallel python rails (action emission needs the id strings).
        self.attempt_ids: List[str] = []
        self.task_ids: List[str] = []
        self._owners: List[object] = []
        # Policy scratch columns: name -> (array, fill value). Compaction
        # and growth preserve them so stateful assessments (temporal marks)
        # survive row movement.
        self._scratch: Dict[str, Tuple[np.ndarray, object]] = {}
        self._order: Optional[np.ndarray] = None
        self._n_dead = 0
        # Per-tick memo for the shared running-rows extraction (glance and
        # the straggler scan both need it within one assess call).
        self._rr_memo: Tuple[float, Optional[np.ndarray]] = (np.nan, None)

    # ------------------------------------------------------------------
    # Network wiring (DESIGN.md §15)
    # ------------------------------------------------------------------
    def init_net(self, net) -> None:
        """Share storage with the network model's columnar state: the
        model's open/close/cut/degrade write-through lands directly in
        the snapshot (one store, no second mirror to drift)."""
        self.node_flows = net.node_flows
        self.node_link_up = net.node_link_up
        self.node_rack = net.node_rack
        self.rack_flows = net.rack_flows
        self.rack_factor = net.rack_factor

    # ------------------------------------------------------------------
    # Job registry
    # ------------------------------------------------------------------
    def job_started(self, job_id: str) -> int:
        idx = self.job_index.get(job_id)
        if idx is None:
            idx = len(self.job_ids)
            self.job_index[job_id] = idx
            self.job_ids.append(job_id)
            self._job_active.append(True)
            self._job_tasks.append(0)
        else:
            self._job_active[idx] = True
        return idx

    def task_created(self, job_idx: int) -> None:
        self._job_tasks[job_idx] += 1

    def job_task_count(self, job_idx: int) -> int:
        return self._job_tasks[job_idx]

    def job_finished(self, job_id: str) -> None:
        idx = self.job_index.get(job_id)
        if idx is None:
            return
        self._job_active[idx] = False
        dead = self.job[:self.n] == idx
        self.active[:self.n][dead] = False
        self._n_dead += int(dead.sum())
        if self._n_dead > 4096 and self._n_dead * 2 > self.n:
            self._compact()

    def active_jobs(self) -> List[Tuple[str, int]]:
        """Active jobs in registration order — exactly the iteration order
        of the reference snapshot's ``job_ids()``."""
        return [(j, i) for i, j in enumerate(self.job_ids)
                if self._job_active[i]]

    # ------------------------------------------------------------------
    # Row maintenance (substrate write-through)
    # ------------------------------------------------------------------
    def _cols(self):
        for name in self._float_cols + self._int_like_cols:
            yield name, getattr(self, name)

    def _grow(self) -> None:
        cap = max(_INIT_CAP, 2 * len(self.a_state))
        for name, col in list(self._cols()):
            new = np.zeros(cap, dtype=col.dtype)
            new[:self.n] = col[:self.n]
            if name in ("work_total", "deps"):
                new[self.n:] = 1  # avoid div-by-zero on unwritten rows
            setattr(self, name, new)
        for name, (col, fill) in list(self._scratch.items()):
            new = np.full(cap, fill, dtype=col.dtype)
            new[:self.n] = col[:self.n]
            self._scratch[name] = (new, fill)

    def add_attempt(self, owner: object, attempt_id: str, task_id: str,
                    task_order: int, attempt_seq: int, job_idx: int,
                    node_idx: int, kind: TaskKind, is_speculative: bool,
                    start_time: float, work_done: float, work_total: float,
                    n_deps: int, task_state: TaskState) -> int:
        if self.n >= len(self.a_state):
            self._grow()
        r = self.n
        self.n += 1
        self.a_state[r] = A_RUNNING
        self.t_state[r] = TSTATE[task_state]
        self.kind[r] = KIND[kind]
        self.job[r] = job_idx
        self.node[r] = node_idx
        self.spec[r] = is_speculative
        self.start[r] = start_time
        self.work_done[r] = work_done
        self.work_total[r] = work_total
        self.last_sync[r] = start_time
        self.fetched[r] = 0
        self.sh_ready[r] = 0
        self.sh_inflight[r] = 0
        self.sh_fail[r] = 0
        self.deps[r] = max(1, n_deps)
        self.compute[r] = False
        self.active[r] = True
        self.skey[r] = task_order * _KEY_STRIDE + attempt_seq
        self.attempt_ids.append(attempt_id)
        self.task_ids.append(task_id)
        self._owners.append(owner)
        for col, fill in self._scratch.values():
            col[r] = fill
        self._order = None
        return r

    def sync_row(self, row: int, work_done: float, last_sync: float) -> None:
        self.work_done[row] = work_done
        self.last_sync[row] = last_sync

    def set_attempt_state(self, row: int, state: AttemptState) -> None:
        self.a_state[row] = ASTATE[state]

    def set_task_state(self, rows, state: TaskState) -> None:
        code = TSTATE[state]
        for r in rows:
            self.t_state[r] = code

    def write_shuffle_rows(self, rows, fetched, ready, inflight,
                           fail) -> None:
        """Bulk shuffle-health write-through: one fancy-indexed store per
        column for a whole drain's worth of fetch-state transitions
        (DESIGN.md §14.2), instead of four scalar writes per transition.
        ``rows`` are live row indices; the value lists are parallel."""
        idx = np.asarray(rows, dtype=np.int64)
        self.fetched[idx] = fetched
        self.sh_ready[idx] = ready
        self.sh_inflight[idx] = inflight
        self.sh_fail[idx] = fail

    def _compact(self) -> None:
        keep = np.flatnonzero(self.active[:self.n])
        for _, col in self._cols():
            col[:len(keep)] = col[keep]
        for col, _fill in self._scratch.values():
            col[:len(keep)] = col[keep]
        self.attempt_ids = [self.attempt_ids[i] for i in keep]
        self.task_ids = [self.task_ids[i] for i in keep]
        self._owners = [self._owners[i] for i in keep]
        for new_r, owner in enumerate(self._owners):
            owner.row = new_r
        self.n = len(keep)
        self._n_dead = 0
        self._order = None

    # ------------------------------------------------------------------
    # Policy scratch columns
    # ------------------------------------------------------------------
    def scratch(self, name: str, dtype, fill) -> np.ndarray:
        ent = self._scratch.get(name)
        if ent is None:
            col = np.full(len(self.a_state), fill, dtype=dtype)
            self._scratch[name] = (col, fill)
            return col
        return ent[0]

    # ------------------------------------------------------------------
    # Queries (all emit rows in canonical reference order)
    # ------------------------------------------------------------------
    def order(self) -> np.ndarray:
        """Live rows sorted by (task creation order, attempt seq) — the
        exact iteration order of the reference snapshot (active jobs in
        submission order → each job's maps then reduces → each task's
        attempts in creation order). Segmented reductions over rows in
        this order accumulate partial sums identically to the per-object
        loops, which is what makes strict-inequality assessments (Eq. 1/3,
        LATE percentiles) bit-equivalent."""
        if self._order is None:
            self._order = np.argsort(self.skey[:self.n], kind="stable")
        return self._order

    def rows_where(self, mask: np.ndarray) -> np.ndarray:
        """Canonical-order row indices of live rows satisfying ``mask``
        (a boolean array over ``[:n]``)."""
        o = self.order()
        return o[mask[o]]

    def progress_at(self, now: float, rows: np.ndarray) -> np.ndarray:
        """ProgressScore ζ for each row, replicating
        ``SimAttempt.progress`` operation-for-operation: frozen for ended
        attempts, linear accrual at the hosting node's current speed for
        running ones, shuffle/compute split for reduces."""
        accrue = (self.a_state[rows] == A_RUNNING) \
            & ((self.kind[rows] == 0) | self.compute[rows])
        wd = self.work_done[rows] + accrue * (
            (now - self.last_sync[rows]) * self.node_speed[self.node[rows]])
        np.minimum(wd, self.work_total[rows], out=wd)
        comp = wd / self.work_total[rows]
        shuffle = self.fetched[rows] / self.deps[rows]
        return np.where(
            self.kind[rows] == 0, comp,
            SHUFFLE_FRACTION * shuffle + (1 - SHUFFLE_FRACTION) * comp)

    def running_rows(self, now: Optional[float] = None) -> np.ndarray:
        """Attempt RUNNING ∧ task RUNNING ∧ job active — the candidate set
        shared by the Eq. 1/2–3 assessments and the straggler scan. With
        ``now`` given, memoized for the duration of one assessment tick
        (the substrate never mutates state mid-assess, and consecutive
        ticks have distinct timestamps)."""
        if now is not None and self._rr_memo[0] == now:
            return self._rr_memo[1]
        m = self.active[:self.n] & (self.a_state[:self.n] == A_RUNNING) \
            & (self.t_state[:self.n] == T_RUNNING)
        rows = self.rows_where(m)
        if now is not None:
            self._rr_memo = (now, rows)
        return rows

    @staticmethod
    def task_segments(torder: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(starts, inverse) for a NONDECREASING per-row task-order array —
        what ``np.unique(..., return_index/inverse)`` yields on sorted
        input, without its O(k log k) sort. Unique task orders are
        ``torder[starts]``."""
        k = len(torder)
        if not k:
            z = np.empty(0, dtype=np.int64)
            return z, z
        new = np.empty(k, dtype=bool)
        new[0] = True
        np.not_equal(torder[1:], torder[:-1], out=new[1:])
        starts = np.flatnonzero(new)
        inv = np.cumsum(new) - 1
        return starts, inv

    def reap_rows(self) -> np.ndarray:
        """Running attempts of COMPLETED tasks that have a COMPLETED
        sibling — the candidates both policies kill each tick. Tasks whose
        state was re-activated (RUNNING again) are excluded by the
        ``t_state`` check, matching the reference guard."""
        live = self.active[:self.n] & (self.t_state[:self.n] == T_COMPLETED)
        if not live.any():
            return np.empty(0, dtype=np.int64)
        rows = self.rows_where(live)
        starts, inv = self.task_segments(self.skey[rows] // _KEY_STRIDE)
        done = np.bincount(
            inv, weights=self.a_state[rows] == A_COMPLETED,
            minlength=len(starts)) > 0
        victims = done[inv] & (self.a_state[rows] == A_RUNNING)
        return rows[victims]

    def idle_task_rows(self) -> np.ndarray:
        """Canonical-order rows of the *first* attempt of each task whose
        task-state is RUNNING while no attempt row is — the AM
        watchdog's re-enqueue candidates (same segment idiom as
        :meth:`reap_rows`; a RUNNING task always has at least one row,
        since PENDING→RUNNING happens at first attempt start and
        COMPLETED→RUNNING re-activation implies prior attempts)."""
        live = self.active[:self.n] & (self.t_state[:self.n] == T_RUNNING)
        if not live.any():
            return np.empty(0, dtype=np.int64)
        rows = self.rows_where(live)
        starts, inv = self.task_segments(self.skey[rows] // _KEY_STRIDE)
        has_running = np.bincount(
            inv, weights=self.a_state[rows] == A_RUNNING,
            minlength=len(starts)) > 0
        return rows[starts[~has_running]]

    def n_running_spec(self) -> int:
        """RUNNING speculative attempts of active jobs — the cluster-wide
        speculation-budget occupancy (DESIGN.md §19.3). Mirrors the
        reference walk over every active job's attempts exactly: task
        state does not gate it (a completed task's still-running backup
        occupies its slot until reaped)."""
        m = self.active[:self.n] & self.spec[:self.n] \
            & (self.a_state[:self.n] == A_RUNNING)
        return int(m.sum())

    def owner(self, row: int) -> object:
        """The substrate object (attempt) that owns ``row``."""
        return self._owners[row]

    def job_local_map(self, active: List[Tuple[str, int]]) -> np.ndarray:
        """job_idx → position in the active job list (-1 if inactive)."""
        local = np.full(len(self.job_ids), -1, dtype=np.int64)
        for pos, (_jid, jidx) in enumerate(active):
            local[jidx] = pos
        return local

    def clone_for_assessment(self) -> "ArraySnapshot":
        """Deep-copy the columns and registries (NOT the substrate owners)
        so a fault-scenario sweep can perturb node/attempt state without
        touching the live simulation (DESIGN.md §13.4)."""
        c = ArraySnapshot.__new__(ArraySnapshot)
        c.node_ids = list(self.node_ids)
        c.node_index = dict(self.node_index)
        for name in ("node_hb", "node_speed", "node_free", "node_total",
                     "node_marked", "node_alive", "node_supp",
                     "node_flows", "node_link_up",
                     "node_rack", "rack_flows", "rack_factor"):
            # .copy() detaches the net-aliased columns: scenario sweeps
            # may perturb rack/flow state without touching the live model
            setattr(c, name, getattr(self, name).copy())
        c.job_index = dict(self.job_index)
        c.job_ids = list(self.job_ids)
        c._job_active = list(self._job_active)
        c._job_tasks = list(self._job_tasks)
        c.n = self.n
        c._float_cols = list(self._float_cols)
        c._int_like_cols = list(self._int_like_cols)
        for name in c._float_cols + c._int_like_cols:
            setattr(c, name, getattr(self, name).copy())
        c.attempt_ids = list(self.attempt_ids)
        c.task_ids = list(self.task_ids)
        c._owners = [None] * len(self._owners)
        c._scratch = {name: (col.copy(), fill)
                      for name, (col, fill) in self._scratch.items()}
        c._order = None if self._order is None else self._order.copy()
        c._n_dead = self._n_dead
        c._rr_memo = (np.nan, None)
        # Drift guard: a field added to __init__ but not cloned here
        # would leak live state into (or crash) the scenario sweep.
        assert set(c.__dict__) == set(self.__dict__), \
            set(self.__dict__) ^ set(c.__dict__)
        return c


# ---------------------------------------------------------------------------
# Plain-state round trip
# ---------------------------------------------------------------------------
_NODE_COLS = ("node_hb", "node_speed", "node_free", "node_total",
              "node_marked", "node_alive", "node_supp", "node_flows",
              "node_link_up", "node_rack", "rack_flows", "rack_factor")


def snapshot_state(arr) -> Dict[str, np.ndarray]:
    """A snapshot's columns, registries and scratch as a flat dict of
    numpy arrays (``np.savez``-ready). Reads attributes by name, so it
    also accepts a snapshot of the reference package, whose layout this
    module copies; substrate owners are not carried."""
    st: Dict[str, np.ndarray] = {
        "node_ids": np.asarray(arr.node_ids, dtype=str),
        "job_ids": np.asarray(arr.job_ids, dtype=str),
        "job_active": np.asarray(arr._job_active, dtype=bool),
        "job_tasks": np.asarray(arr._job_tasks, dtype=np.int64),
        "n": np.asarray(arr.n, dtype=np.int64),
        "attempt_ids": np.asarray(arr.attempt_ids, dtype=str),
        "task_ids": np.asarray(arr.task_ids, dtype=str),
    }
    for name in _NODE_COLS + tuple(arr._float_cols + arr._int_like_cols):
        st[name] = getattr(arr, name).copy()
    for name, (col, fill) in arr._scratch.items():
        st["scratch/" + name] = col.copy()
        st["fill/" + name] = np.asarray(fill, dtype=col.dtype)
    return st


def snapshot_from_state(state) -> ArraySnapshot:
    """Build a snapshot of this package from :func:`snapshot_state`'s
    dict (or the ``np.load`` of its ``.npz``). Assessment on the result
    sees exactly the state that was exported."""
    arr = ArraySnapshot([str(x) for x in state["node_ids"]])
    for name in _NODE_COLS:
        setattr(arr, name, np.array(state[name]))
    arr.job_ids = [str(x) for x in state["job_ids"]]
    arr.job_index = {j: i for i, j in enumerate(arr.job_ids)}
    arr._job_active = [bool(x) for x in state["job_active"]]
    arr._job_tasks = [int(x) for x in state["job_tasks"]]
    for name in arr._float_cols + arr._int_like_cols:
        setattr(arr, name, np.array(state[name]))
    arr.n = int(state["n"])
    arr.attempt_ids = [str(x) for x in state["attempt_ids"]]
    arr.task_ids = [str(x) for x in state["task_ids"]]
    arr._owners = [None] * arr.n
    for key in state:
        if key.startswith("scratch/"):
            name = key[len("scratch/"):]
            arr._scratch[name] = (np.array(state[key]),
                                  state["fill/" + name].item())
    return arr


# ---------------------------------------------------------------------------
# Padded device mirrors (DESIGN.md §13.2)
# ---------------------------------------------------------------------------
class DeviceColumns:
    """Padded, fixed-shape host mirrors of an :class:`ArraySnapshot` for
    the torch backend's CUDA kernels (DESIGN.md §13.2).

    Device kernels need static shapes or every tick retraces. This
    exporter keeps one pre-padded buffer per attempt column:

    - row capacity is a power of two (min :data:`MIN_ROWS`), grown by
      doubling and **never shrunk** — device buffers keep their shapes
      until the simulation genuinely outgrows them;
    - pad rows (and rows vacated by compaction) hold neutral fills:
      zeros, except ``work_total``/``deps`` = 1 so unmasked elementwise
      math (the ζ progress projection divides by both) stays finite —
      kernels must still mask with ``position < n_rows`` before any
      reduction;
    - the canonical row order (:meth:`ArraySnapshot.order`) is exported
      zero-padded, so device segmented reductions visit live rows in
      exactly the reference accumulation order (§11.3);
    - the job axis is padded the same way (``jobs_cap`` for the
      job-registry axis, ``jcap`` for the active-job output axis).

    ``refresh`` returns plain numpy arrays; the caller owns the
    host→device transfer (keeping this module free of torch).
    """

    MIN_ROWS = 256
    MIN_JOBS = 4

    # Columns exported per attempt row, with their pad fill.
    _FILLS = {
        "a_state": 0, "t_state": 0, "kind": 0, "job": 0, "node": 0,
        "spec": False, "start": 0.0, "work_done": 0.0, "work_total": 1.0,
        "last_sync": 0.0, "fetched": 0, "deps": 1, "compute": False,
        "active": False, "skey": 0, "sh_ready": 0, "sh_inflight": 0,
        "sh_fail": 0,
    }

    def __init__(self, arr: ArraySnapshot):
        self.arr = arr
        self.cap = 0
        self.jobs_cap = 0
        self.jcap = 0
        self._buf: Dict[str, np.ndarray] = {}
        self._scratch_buf: Dict[str, np.ndarray] = {}
        self._order_buf = np.zeros(0, dtype=np.int64)
        self._jl_buf = np.zeros(0, dtype=np.int64)
        self._last_n = 0

    @staticmethod
    def _pow2(n: int, floor: int) -> int:
        cap = floor
        while cap < n:
            cap *= 2
        return cap

    def refresh(self, active: List[Tuple[str, int]],
                scratch_names: Tuple[str, ...] = ()) -> Dict[str, object]:
        """Re-mirror the snapshot; returns the padded column dict."""
        arr = self.arr
        n = arr.n
        cap = self._pow2(max(n, 1), max(self.cap, self.MIN_ROWS))
        if cap != self.cap:
            self.cap = cap
            for name, fill in self._FILLS.items():
                col = getattr(arr, name)
                self._buf[name] = np.full(cap, fill, dtype=col.dtype)
            self._scratch_buf = {}
            self._order_buf = np.zeros(cap, dtype=np.int64)
            self._last_n = 0
        for name in scratch_names:
            if name not in self._scratch_buf:
                col, fill = arr._scratch[name]
                self._scratch_buf[name] = np.full(cap, fill,
                                                  dtype=col.dtype)
        # Rows vacated since the last refresh (compaction) must re-pad.
        clear_to = max(self._last_n, n)
        for name, fill in self._FILLS.items():
            buf = self._buf[name]
            buf[:n] = getattr(arr, name)[:n]
            if clear_to > n:
                buf[n:clear_to] = fill
        for name, buf in self._scratch_buf.items():
            col, fill = arr._scratch[name]
            buf[:n] = col[:n]
            if clear_to > n:
                buf[n:clear_to] = fill
        order = arr.order()
        self._order_buf[:n] = order
        if clear_to > n:
            self._order_buf[n:clear_to] = 0
        self._last_n = n
        # Job axes: the registry axis (job_local gather) and the active
        # axis (per-job kernel outputs) both grow by doubling.
        self.jobs_cap = self._pow2(max(len(arr.job_ids), 1),
                                   max(self.jobs_cap, self.MIN_JOBS))
        jl = arr.job_local_map(active)
        if len(self._jl_buf) != self.jobs_cap:
            self._jl_buf = np.full(self.jobs_cap, -1, dtype=np.int64)
        self._jl_buf[:len(jl)] = jl
        self._jl_buf[len(jl):] = -1
        self.jcap = self._pow2(max(len(active), 1),
                               max(self.jcap, self.MIN_JOBS))
        out: Dict[str, object] = dict(self._buf)
        out.update(self._scratch_buf)
        out["order"] = self._order_buf
        out["job_local"] = self._jl_buf
        out["n_rows"] = n
        out["n_jobs"] = len(active)
        out["node_hb"] = arr.node_hb
        out["node_speed"] = arr.node_speed
        out["node_marked"] = arr.node_marked
        return out
