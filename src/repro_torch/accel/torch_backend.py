"""Torch assessment backend: padded column mirrors on a torch device, the
§11 projections as eager torch ops, and the four assessment reductions as
hand-written CUDA kernels (:mod:`repro_torch.accel.kernels`).

Dispatch. Each reduction has a wrapper (:func:`spatial`, :func:`temporal`,
:func:`late`, :func:`reap`) and a plain torch version of the same
function (:func:`spatial_ref`, ...). A wrapper given CPU tensors runs the
plain version; given CUDA tensors it launches the kernel or raises. The
backend built on ``device="cpu"`` therefore runs the plain versions, and
on a CUDA device the kernels.

Exactness. Results equal :class:`~repro_torch.accel.numpy_backend.
NumpyBackend`'s bit for bit:

- :func:`prep` gathers the columns into canonical row order and repeats
  ``ArraySnapshot.progress_at`` op for op; every eager op is its own
  kernel, so nothing fuses into an FMA, and ``int/int`` is cast to
  float64 first (torch would give float32);
- the plain versions sum buckets with ``index_add_``, which on the CPU
  adds in operand (canonical) order like ``np.bincount``; the kernels
  give each bucket to one thread that adds in that order;
- neighbourhood sums are written out left to right over k, the order
  ``np.nansum`` uses for k < 8 (the glance's default k is 4);
- LATE's percentile repeats numpy's linear interpolation term for term;
  maxima, order statistics and flags are order-free.

Task segments. B3 and B4 read each task's attempts as one contiguous run
of rows with the same ``tseg`` in canonical order, all of one job;
:func:`prep` builds ``tseg`` that way and :func:`check_segments` checks
it. The plain versions index by id and do not need it.

Scenario axis. :func:`prep` and the B1/B3/B4 wrappers also take columns
stacked along a leading scenario axis, (N, cap): the batched sweep
(:mod:`repro_torch.accel.sweep`) prepares N perturbed snapshots at once
and launches each kernel once for all of them. Every op is elementwise
or row-wise per scenario, so each scenario's result equals its own N = 1
call bit for bit; the plain versions loop over the scenarios.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.accel import kernels as K
from repro_torch.accel.base import TMARK, TPROG, AssessmentBackend
from repro_torch.core.arrays import SHUFFLE_FRACTION, ArraySnapshot, \
    DeviceColumns

F64 = torch.float64

# Attempt columns the assessment reads (the shuffle-health ones are not).
_UPLOAD = ("a_state", "t_state", "kind", "node", "job", "spec", "start",
           "work_done", "work_total", "last_sync", "fetched", "deps",
           "compute", "active", "skey", "order", "job_local", TMARK, TPROG)


# ---------------------------------------------------------------------------
# Elementwise preparation (eager torch ops)
# ---------------------------------------------------------------------------
def prep(cols: dict, now: float) -> dict:
    """Canonical-order gather + the §11 elementwise projections.

    ``cols`` holds the padded (cap,) tensors of :data:`_UPLOAD` plus
    ``node_speed`` and the python int ``n_rows`` — or the same stacked
    (N, cap) / (N, n) per scenario with ``n_rows`` an (N, 1) tensor; the
    scratch columns are optional. Returns (cap,) or (N, cap) tensors in
    canonical order; pad positions gather row 0 and are masked out of
    ``active`` by position. ``tseg`` is the task-segment id within its
    scenario (task segments are contiguous in canonical order; ids are
    below ``cap``)."""
    order = cols["order"]
    cap = order.shape[-1]
    pos = torch.arange(cap, device=order.device)
    posv = pos < cols["n_rows"]

    def g(name):
        return torch.gather(cols[name], -1, order)

    a_state = g("a_state")
    t_state = g("t_state")
    kind = g("kind")
    node = g("node").long()
    start = g("start")
    work_total = g("work_total")
    active = g("active") & posv
    # ProgressScore ζ, replicating ArraySnapshot.progress_at op for op.
    accrue = (a_state == 0) & ((kind == 0) | g("compute"))
    wd = g("work_done") + accrue.to(F64) * (
        (now - g("last_sync")) * torch.gather(cols["node_speed"], -1, node))
    wd = torch.minimum(wd, work_total)
    comp = wd / work_total
    shuffle = g("fetched").to(F64) / g("deps").to(F64)
    prog = torch.where(kind == 0, comp,
                       SHUFFLE_FRACTION * shuffle
                       + (1 - SHUFFLE_FRACTION) * comp)
    # job_local = -1 (inactive job) maps to 0; such rows are not active.
    jl = torch.gather(cols["job_local"], -1, g("job").long())
    jls = torch.where(jl >= 0, jl, 0)
    torder = g("skey") >> 20
    prev = torch.cat([torder[..., :1] - 1, torder[..., :-1]], -1)
    tseg = torch.cumsum((torder != prev).long(), -1) - 1
    # Each pad position is a segment of its own (ids past every live
    # segment's): no kernel walks the pad run as one long segment.
    tseg = torch.where(posv, tseg, pos)
    i32 = torch.int32
    out = {
        "cap": cap, "order": order, "a_state": a_state, "t_state": t_state,
        "kind": kind, "node": node, "spec": g("spec"), "start": start,
        "active": active, "prog": prog, "jls": jls, "tseg": tseg,
        "running": active & (a_state == 0) & (t_state == 1),
        # int32 views the kernels take
        "node32": node.to(i32), "kind32": kind.to(i32),
        "jls32": jls.to(i32), "tseg32": tseg.to(i32),
        "spec32": g("spec").to(i32), "order32": order.to(i32),
        "a_state32": a_state.to(i32),
    }
    if TMARK in cols:
        out["mark"], out["tprog"] = g(TMARK), g(TPROG)
    return out


def check_segments(tseg: torch.Tensor, jls: torch.Tensor) -> None:
    """Raise unless every task-segment id of ``tseg`` ((cap,) or (N, cap)
    per scenario) is one contiguous run of rows and the rows of a run share
    one job in ``jls``. B3 and B4 rely on both: their kernels walk each run
    from its first row, and B3 credits a segment to its first row's job.
    :func:`prep` builds ``tseg`` so (a cumulative count of task changes in
    canonical order, pad rows after every live id)."""
    ts = tseg.reshape(-1, tseg.shape[-1]).long()
    js = jls.reshape(-1, jls.shape[-1]).long()
    head = torch.ones_like(ts, dtype=torch.bool)
    head[:, 1:] = ts[:, 1:] != ts[:, :-1]
    srt = ts.sort(dim=1).values
    ids = 1 + (srt[:, 1:] != srt[:, :-1]).sum(dim=1)
    if not torch.equal(ids, head.sum(dim=1)):
        raise ValueError("task segments are not contiguous runs of tseg")
    pos = torch.arange(ts.shape[1], device=ts.device).expand_as(ts)
    first = torch.cummax(torch.where(head, pos, 0), dim=1).values
    if not torch.equal(js, torch.gather(js, 1, first)):
        raise ValueError("a task segment spans more than one job")


def _rate(p: dict, now: float) -> torch.Tensor:
    return p["prog"] / torch.clamp_min(now - p["start"], 1e-9)


# Each kernel's arguments from prepared columns (one tick, or stacked
# scenarios): the backend and the batched sweep build them alike.
def spatial_inputs(p: dict, now: float, nh: torch.Tensor, jcap: int
                   ) -> tuple:
    return (_rate(p, now), p["node32"], p["kind32"], p["jls32"],
            p["running"].to(torch.int32), nh, jcap)


def late_inputs(p: dict, now: float, min_runtime: float, q: float,
                win_factor: float, jcap: int) -> tuple:
    i32 = torch.int32
    runatt = p["active"] & (p["a_state"] == 0)
    return (p["prog"], p["start"], _rate(p, now), p["spec32"],
            p["tseg32"], p["jls32"], p["running"].to(i32), runatt.to(i32),
            p["order32"], now, min_runtime, q, win_factor, jcap)


def reap_inputs(p: dict) -> tuple:
    live = p["active"] & (p["t_state"] == 2)
    return p["a_state32"], p["tseg32"], live.to(torch.int32)


def failure_core(now: float, node_hb, node_marked, declared, thresholds,
                 responsive_window: float):
    """Eq. 4 masks (responsive, failure candidates) as torch ops, per
    node or per (scenario, node)."""
    silent = now - node_hb
    resp = silent <= responsive_window
    cand = ~resp & ~declared & ~node_marked & (silent > thresholds)
    return resp, cand


def _per_scenario(fn, rows: tuple, rest: tuple):
    """A plain version over stacked (N, cap) rows: one call per scenario,
    results stacked along a new leading axis."""
    outs = [fn(*(r[i] for r in rows), *rest) for i in range(len(rows[0]))]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


# ---------------------------------------------------------------------------
# Device dispatch
# ---------------------------------------------------------------------------
def on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors (the plain version runs), False for CUDA
    tensors (the kernel launches); raises for anything else — there is
    no fallback."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"kernel tensors on mixed or unsupported devices "
                     f"{sorted(kinds)}")


def _ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum the last axis by left-to-right adds (np.nansum's order for a
    small axis); ``torch.sum`` may re-associate."""
    acc = x[..., 0]
    for kk in range(1, x.shape[-1]):
        acc = acc + x[..., kk]
    return acc


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """``np.sqrt``, correctly rounded. ``torch.sqrt`` of a CPU float64
    tensor is not: on an AVX512 host it differs from ``np.sqrt`` in the
    last bit for about 0.7 % of inputs, which flips Eq. 1 at its boundary
    (``mean - std == P`` in exact arithmetic). CUDA's float64 sqrt is the
    IEEE square root, as the kernels' is."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _bucket_add(use, seg, vals, nb) -> torch.Tensor:
    """Masked bucket sums; masked rows go to a dump bucket past ``nb``."""
    idx = torch.where(use, seg, nb)
    out = torch.zeros(nb + 1, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, idx, torch.where(use, vals, 0))[:nb]


# -- B1 ---------------------------------------------------------------------
def spatial_ref(rho, node, kind, jls, running, nh, jcap: int
                ) -> torch.Tensor:
    """Plain version of B1: (jcap, 2, n) Eq. 1 hits, or (N, jcap, 2, n)
    for (N, cap) rows."""
    if rho.dim() == 2:
        return _per_scenario(spatial_ref, (rho, node, kind, jls, running),
                             (nh, jcap))
    n = nh.shape[0]
    nb = jcap * 2 * n
    use = running == 1
    seg = (jls.long() * 2 + kind.long()) * n + node.long()
    sums = _bucket_add(use, seg, rho, nb)
    counts = _bucket_add(use, seg, torch.ones_like(seg), nb)
    P = torch.where(counts > 0, sums / counts.clamp_min(1).to(F64),
                    torch.nan).reshape(jcap * 2, n)
    Pn = P[:, nh.long()]                               # (g, n, k)
    valid = ~torch.isnan(Pn)
    cnt = valid.sum(dim=2)
    denom = cnt.clamp_min(1).to(F64)
    mean = _ordered_sum(torch.where(valid, Pn, 0.0)) / denom
    d = Pn - mean[:, :, None]
    var = _ordered_sum(torch.where(valid, d * d, 0.0)) / denom
    std = _sqrt(var)
    fired = (cnt >= 2) & ~torch.isnan(P) & (P < mean - std)
    return fired.reshape(jcap, 2, n)


def spatial(rho, node, kind, jls, running, nh, jcap: int) -> torch.Tensor:
    if on_cpu(rho, node, kind, jls, running, nh):
        return spatial_ref(rho, node, kind, jls, running, nh, jcap)
    return K.launch_spatial(rho, node, kind, jls, running, nh, jcap)


# -- B2 ---------------------------------------------------------------------
def temporal_ref(prog, tprog, node, jls, alive, jcap: int, n: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B2: (jcap, n) ζ_now / ζ_prev, NaN where empty."""
    use = alive == 1
    seg = jls.long() * n + node.long()
    nb = jcap * n
    zn = _bucket_add(use, seg, prog, nb)
    zp = _bucket_add(use, seg, tprog, nb)
    cnt = _bucket_add(use, seg, torch.ones_like(seg), nb)
    have = cnt > 0
    return (torch.where(have, zn, torch.nan).reshape(jcap, n),
            torch.where(have, zp, torch.nan).reshape(jcap, n))


def temporal(prog, tprog, node, jls, alive, jcap: int, n: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    if on_cpu(prog, tprog, node, jls, alive):
        return temporal_ref(prog, tprog, node, jls, alive, jcap, n)
    return K.launch_temporal(prog, tprog, node, jls, alive, jcap, n)


# -- B3 ---------------------------------------------------------------------
def _seg_reduce(seg, vals, size, init, how) -> torch.Tensor:
    out = torch.full((size,), init, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, seg, vals, how)


def percentile_runs(srt, first, m, q: float) -> torch.Tensor:
    """``np.percentile(x, q)`` (method 'linear') of every sorted run
    ``srt[first[j]:first[j] + m[j]]``: numpy's virtual index
    ``(m - 1) * (q / 100)``, its two order statistics and its ``_lerp``
    (including the ``t >= 0.5`` form), term for term."""
    top = (m - 1).clamp_min(0)
    v = (m - 1).to(F64) * (q / 100.0)
    flo = torch.floor(v)
    gamma = v - flo
    loi = torch.minimum(flo.long().clamp_min(0), top)
    hii = torch.minimum(loi + 1, top)
    last = srt.shape[0] - 1
    a = srt[(first + loi).clamp(0, last)]
    b = srt[(first + hii).clamp(0, last)]
    diff = b - a
    return torch.where(gamma >= 0.5, b - diff * (1 - gamma),
                       a + diff * gamma)


def late_ref(prog, start, rate, spec, tseg, jls, running, runatt, order,
             now: float, min_runtime: float, q: float, win_factor: float,
             jcap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B3: (jcap,) int32 LATE victims and winning flags,
    or (N, jcap) each for (N, cap) rows."""
    if prog.dim() == 2:
        return _per_scenario(
            late_ref, (prog, start, rate, spec, tseg, jls, running, runatt,
                       order), (now, min_runtime, q, win_factor, jcap))
    cap = prog.shape[0]
    dev = prog.device
    pos = torch.arange(cap, device=dev)
    ts = tseg.long()
    job = jls.long()
    ninf = -torch.inf
    run = running == 1
    sp = spec == 1
    # Per task: best running attempt (max ζ, first position on ties).
    segmax = _seg_reduce(ts, torch.where(run, prog, ninf), cap, ninf, "amax")
    cand = run & (prog == segmax[ts])
    bpos = _seg_reduce(ts, torch.where(cand, pos, cap), cap, cap, "amin")
    hspec = _seg_reduce(ts, (run & sp).long(), cap, 0, "amax") > 0
    seg_ok = bpos < cap
    bp = bpos.clamp_max(cap - 1)
    best_prog, best_start, seg_job = prog[bp], start[bp], job[bp]
    okm = seg_ok & ~hspec & (now - best_start >= min_runtime)
    rho = best_prog / torch.clamp_min(now - best_start, 1e-9)
    est = (1.0 - best_prog) / torch.clamp_min(rho, 1e-9)
    ones = torch.ones(cap, dtype=torch.long, device=dev)
    nrows = _bucket_add(run, job, ones, jcap)
    kj = torch.where(okm, seg_job, jcap)
    m = _bucket_add(okm, seg_job, ones, jcap)
    # np.percentile(rho, q) per job over a job-keyed sorted run of ρ.
    by_rho = torch.sort(torch.where(okm, rho, torch.inf), stable=True)[1]
    by_job = by_rho[torch.sort(kj[by_rho], stable=True)[1]]
    thresh = percentile_runs(rho[by_job], torch.cumsum(m, 0) - m, m, q)
    # Victim: largest est among slow candidates, lowest task on ties.
    slow = okm & (rho < thresh[seg_job.clamp(0, jcap - 1)])
    kv = torch.where(slow, seg_job, jcap)
    emax = _seg_reduce(kv, torch.where(slow, est, ninf), jcap + 1, ninf,
                       "amax")
    top_est = slow & (est == emax[kv])
    vseg = _seg_reduce(kv, torch.where(top_est, pos, cap), jcap + 1, cap,
                       "amin")[:jcap]
    vrow = order[bpos[vseg.clamp_max(cap - 1)].clamp_max(cap - 1)]
    good = (nrows >= 2) & (m >= 2) & (vseg < cap)
    victim = torch.where(good, vrow, -1).to(torch.int32)
    # Collective: per task, max speculative vs max original rate.
    att = runatt == 1
    hi = _seg_reduce(ts, torch.where(att & sp, rate, ninf), cap, ninf, "amax")
    lo = _seg_reduce(ts, torch.where(att & ~sp, rate, ninf), cap, ninf,
                     "amax")
    has_spec = _seg_reduce(ts, (att & sp).long(), cap, 0, "amax") > 0
    has_orig = _seg_reduce(ts, (att & ~sp).long(), cap, 0, "amax") > 0
    win_seg = has_spec & (~has_orig | (hi > lo * win_factor))
    wjob = _seg_reduce(ts, torch.where(att, job, -1), cap, -1, "amax")
    hit = win_seg & (wjob >= 0)
    win = _bucket_add(hit, wjob, ones, jcap) > 0
    return victim, win.to(torch.int32)


def late(prog, start, rate, spec, tseg, jls, running, runatt, order,
         now: float, min_runtime: float, q: float, win_factor: float,
         jcap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile {q} outside [0, 100]")
    args = (prog, start, rate, spec, tseg, jls, running, runatt, order)
    if on_cpu(*args):
        return late_ref(*args, now, min_runtime, q, win_factor, jcap)
    return K.launch_late(*args, now, min_runtime, q, win_factor, jcap)


# -- B4 ---------------------------------------------------------------------
def reap_ref(a_state, tseg, live) -> torch.Tensor:
    """Plain version of B4: (cap,) int32 reapable-sibling mask, or
    (N, cap) for (N, cap) rows."""
    if a_state.dim() == 2:
        return _per_scenario(reap_ref, (a_state, tseg, live), ())
    cap = a_state.shape[0]
    ts = tseg.long()
    lv = live == 1
    done = _seg_reduce(ts, (lv & (a_state == 1)).long(), cap, 0, "amax")
    return (lv & (a_state == 0) & (done[ts] > 0)).to(torch.int32)


def reap(a_state, tseg, live) -> torch.Tensor:
    if on_cpu(a_state, tseg, live):
        return reap_ref(a_state, tseg, live)
    return K.launch_reap(a_state, tseg, live)


# ---------------------------------------------------------------------------
# Backend
# ---------------------------------------------------------------------------
def neighborhood_tensor(neighborhoods: np.ndarray,
                        device: torch.device) -> torch.Tensor:
    """Checked (n, k) int32 neighbourhood table on ``device``."""
    nh = np.asarray(neighborhoods)
    n = nh.shape[0]
    if nh.ndim != 2 or nh.size and (nh.min() < 0 or nh.max() >= n):
        raise ValueError("neighborhoods must be (n, k) node indices")
    return torch.from_numpy(np.ascontiguousarray(nh.astype(np.int32))).to(
        device)


def require_device(device: str, who: str) -> torch.device:
    """``device`` as a torch device; raises for a CUDA device when no
    card is present (no fallback to the CPU) and for other kinds."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device; pass device='cpu' for "
                           f"a CPU run")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{who}: unsupported device {device!r}")
    return dev


class TorchBackend(AssessmentBackend):
    """Assessment on a torch device. ``device="cuda"`` (the default, also
    what ``get_backend(None)`` builds) runs the CUDA kernels and raises if
    no card is present; ``device="cpu"`` runs their plain versions."""

    name = "torch"

    def __init__(self, device: str = "cuda") -> None:
        self.device = require_device(device, "TorchBackend")
        self._dc: Optional[DeviceColumns] = None
        self._memo: Tuple[float, Optional[tuple]] = (np.nan, None)
        # The collective queries winning() once per straggler job within
        # a tick; the whole (jcap,) vector is computed on the first call.
        self._win_memo = (np.nan, np.nan, None, None)
        self._nh_host = None
        self._nh_dev = None

    def _t(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    # ------------------------------------------------------------------
    def _prep(self, arr: ArraySnapshot, now: float, active) -> tuple:
        """Upload the padded mirror and prepare it once per tick
        (assessments never mutate state mid-tick; the clock strictly
        increases). Keyed on the snapshot too — an instance may be
        shared across simulations."""
        if self._memo[0] == now and self._dc is not None \
                and self._dc.arr is arr:
            return self._memo[1]
        if self._dc is None or self._dc.arr is not arr:
            self._dc = DeviceColumns(arr)
        arr.scratch(TMARK, np.int64, -1)
        arr.scratch(TPROG, np.float64, np.nan)
        host = self._dc.refresh(active, scratch_names=(TMARK, TPROG))
        cols = {name: self._t(host[name]) for name in _UPLOAD}
        cols["node_speed"] = self._t(host["node_speed"])
        cols["n_rows"] = host["n_rows"]
        out = (prep(cols, now), self._dc.jcap)
        self._memo = (now, out)
        return out

    def _nh(self, neighborhoods: np.ndarray) -> torch.Tensor:
        if self._nh_host is not neighborhoods:
            self._nh_dev = neighborhood_tensor(neighborhoods, self.device)
            self._nh_host = neighborhoods
        return self._nh_dev

    # -- each kernel's arguments for one tick (chip_smoke.py times the
    # -- kernels on exactly these) ---------------------------------------
    def spatial_args(self, arr, now, active, neighborhoods) -> tuple:
        p, jcap = self._prep(arr, now, active)
        return spatial_inputs(p, now, self._nh(neighborhoods), jcap)

    def temporal_args(self, arr, now, active, samp_flag, init_flag, prevk):
        """B2's arguments, plus the Eq. 2 write mask and the rows' new
        marks and ζ for the scratch write-back."""
        p, jcap = self._prep(arr, now, active)
        J = len(active)
        sampd = np.zeros(jcap, dtype=bool)
        sampd[:J] = samp_flag
        initd = np.zeros(jcap, dtype=bool)
        initd[:J] = init_flag
        prevkd = np.full(jcap, -2, dtype=np.int64)
        prevkd[:J] = prevk
        samp, init, prev = self._t(sampd), self._t(initd), self._t(prevkd)
        jls = p["jls"]
        samp_r = p["running"] & samp[jls]
        alive = samp_r & (p["mark"] == prev[jls])
        args = (p["prog"], torch.where(alive, p["tprog"], 0.0), p["node32"],
                p["jls32"], alive.to(torch.int32), jcap, len(arr.node_ids))
        wmask = samp_r | (p["running"] & init[jls])
        newmark = torch.where(wmask, torch.where(samp, prev + 1, 0)[jls],
                              p["mark"])
        newtprog = torch.where(wmask, p["prog"], p["tprog"])
        return args, wmask, newmark, newtprog

    def late_args(self, arr, now, active, min_runtime, q,
                  win_factor) -> tuple:
        p, jcap = self._prep(arr, now, active)
        return late_inputs(p, now, min_runtime, q, win_factor, jcap)

    def reap_args(self, arr, now) -> tuple:
        p, _jcap = self._prep(arr, now, arr.active_jobs())
        return reap_inputs(p)

    # ------------------------------------------------------------------
    def spatial_hits(self, arr, now, active, neighborhoods):
        fired = spatial(*self.spatial_args(arr, now, active, neighborhoods))
        return fired.any(dim=1)[:len(active)].cpu().numpy()

    def temporal_zeta(self, arr, now, active, samp_flag, init_flag, prevk):
        args, wmask, newmark, newtprog = self.temporal_args(
            arr, now, active, samp_flag, init_flag, prevk)
        zn, zp = temporal(*args)
        # Scratch write-back on the host: this sample's marks, computed
        # in canonical order, land on the host columns.
        n_rows = arr.n
        w = wmask[:n_rows].cpu().numpy()
        if w.any():
            rows = arr.order()[w]
            arr.scratch(TMARK, np.int64, -1)[rows] = \
                newmark[:n_rows].cpu().numpy()[w]
            arr.scratch(TPROG, np.float64, np.nan)[rows] = \
                newtprog[:n_rows].cpu().numpy()[w]
        J = len(active)
        return zn[:J].cpu().numpy(), zp[:J].cpu().numpy()

    def failure_masks(self, now, node_hb, node_marked, declared,
                      thresholds, responsive_window):
        resp, cand = failure_core(
            now, self._t(node_hb), self._t(node_marked), self._t(declared),
            self._t(thresholds), responsive_window)
        return resp.cpu().numpy(), cand.cpu().numpy()

    def late_victims(self, arr, now, active, eligible, min_runtime,
                     slow_task_percentile):
        victims, _win = late(*self.late_args(
            arr, now, active, min_runtime, slow_task_percentile, 1.0))
        return victims[:len(active)].cpu().numpy().astype(np.int64)

    def winning(self, arr, now, job_idx, win_factor):
        active = arr.active_jobs()
        if self._win_memo[0] == now and self._win_memo[1] == win_factor \
                and self._win_memo[3] is arr:
            win = self._win_memo[2]
        else:
            # LATE's outputs are unused here; its parameters are fixed as
            # in the reference wrapper (min_runtime 10 s, q 25).
            _victims, w = late(*self.late_args(arr, now, active, 10.0,
                                               25.0, win_factor))
            win = w.cpu().numpy()
            self._win_memo = (now, win_factor, win, arr)
        jl = arr.job_local_map(active)
        pos = jl[job_idx] if 0 <= job_idx < len(jl) else -1
        if pos < 0:
            return False
        return bool(win[pos])

    def reap_rows(self, arr, now):
        out = reap(*self.reap_args(arr, now))
        mask = out[:arr.n].cpu().numpy().astype(bool)
        return arr.order()[mask]


__all__ = [
    "TorchBackend", "check_segments", "failure_core", "late", "late_inputs",
    "late_ref", "neighborhood_tensor", "on_cpu", "percentile_runs", "prep",
    "reap", "reap_inputs", "reap_ref", "require_device", "spatial",
    "spatial_inputs", "spatial_ref", "temporal", "temporal_ref",
]
