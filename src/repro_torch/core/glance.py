"""Neighborhood glance (§III.A): three independent assessments that expand
the speculator's scope in space (Eq. 1), time (Eq. 2–3), and responsiveness
(Eq. 4 adaptive failure threshold).

Stateful pieces (per-node ζ history for Δ, per-node outage windows for
Eq. 4) live here; the math is delegated to ``repro_torch.core.metrics`` so the
simulator and the live runtime assess identically.

Two assessment paths share all state semantics (DESIGN.md §11):

- the **reference** per-object path walks ``snap.tasks``/``snap.nodes``
  views — used by the live runtime coordinator and the unit tests;
- the **vectorized** path runs when the substrate attaches a columnar
  ``ArraySnapshot`` (``snap.arrays``): one segmented-reduction pass over
  (job, kind, node) covers every job and both phases at once, and the
  Eq. 4 monitor is a handful of whole-cluster array ops. It is
  bit-equivalent to the reference path (same operand order, same
  accumulation order) — enforced by tests/test_columnar.py.

The vectorized path's dense math runs behind a pluggable
``AssessmentBackend`` (DESIGN.md §13): ``numpy`` (the reference) or
``torch`` (hand-written CUDA kernels on the card, their plain torch
versions on the CPU) — selected via ``GlanceConfig.assess_backend``. All glance *state* (streaks, Δ
histories, outage windows) stays host-side regardless of backend.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.accel.base import AssessmentBackend, get_backend
from repro_torch.core import metrics as M
from repro_torch.core.types import AttemptState, ClusterSnapshot, TaskKind, TaskState
from repro_torch.obs.trace import (
    K_GLANCE_FAIL,
    K_GLANCE_SPATIAL,
    K_GLANCE_TEMPORAL,
    K_THRESH,
)


@dataclasses.dataclass(frozen=True)
class GlanceConfig:
    # Eq. 3 slowdown threshold (paper default 0.1).
    threshold_slowdown: float = 0.1
    # Eq. 4 window length L (paper tunes 1..8; larger = more accurate).
    failure_window: int = 4
    # Nodes per spatial neighborhood, including self (paper: ≥3 useful).
    size_neighbor: int = 4
    # Initial per-node unresponsiveness threshold (s) before any history —
    # deliberately much shorter than YARN's 600 s NM expiry; Eq. 4 then
    # adapts it per node. Floors/caps keep transient hiccups from flapping.
    fail_threshold_init: float = 10.0
    fail_threshold_min: float = 3.0
    fail_threshold_max: float = 120.0
    # Safety factor over the Eq. 4 estimate of the next outage duration.
    fail_threshold_margin: float = 1.5
    # A node is "responsive" when silent for less than this (≈1.5× the
    # substrate's heartbeat period; the training runtime heartbeats every
    # 50 ms and overrides accordingly).
    responsive_window: float = 1.5
    # Minimum seconds between Δ samples (Eq. 2 sampling period).
    temporal_period: float = 3.0
    # Eq. 1 must hold for this many consecutive assessments before a node
    # is reported slow — mean−σ alone fires on the ~16 % Gaussian tail of
    # ordinary execution noise, which burns containers on healthy clusters.
    spatial_consecutive: int = 3
    # Eq. 3 reference window: Δ|Ti is compared against the MAX of the last
    # W samples, not just Δ|Ti−1 — with finite sampling a slowdown cliff
    # always straddles one sample boundary, and the diluted transition
    # sample would otherwise mask the drop from the strict ratio test.
    temporal_window: int = 5
    # Enable flags — Fig. 7(a) ablates these independently.
    enable_spatial: bool = True
    enable_temporal: bool = True
    enable_failure: bool = True
    # Assessment-compute backend for the vectorized (columnar) path:
    # None (torch on the card) | "torch" | "numpy" (DESIGN.md §13).
    assess_backend: Optional[str] = None


def build_neighborhoods(node_ids: Sequence[str], size_neighbor: int = 4,
                        topology: Optional[Dict[str, Sequence[str]]] = None
                        ) -> np.ndarray:
    """(n, k) neighborhood index rows. Default = ring segments of
    ``size_neighbor`` (the ICI-torus segment / rack analogue); an
    explicit adjacency overrides. Shared by the glance and the batched
    sweep (DESIGN.md §13.4)."""
    n = len(node_ids)
    k = min(size_neighbor, n)
    if topology is not None:
        node_index = {nid: i for i, nid in enumerate(node_ids)}
        rows = []
        for nid in node_ids:
            nh = [node_index[m] for m in topology[nid]][:k]
            while len(nh) < k:  # pad with self
                nh.append(node_index[nid])
            rows.append(nh)
        return np.asarray(rows, dtype=int)
    # Ring: node i's neighborhood = {i, i±1, ...} wrapped, k wide.
    offsets = np.arange(k) - (k // 2)
    idx = (np.arange(n)[:, None] + offsets[None, :]) % n
    return idx.astype(int)


@dataclasses.dataclass
class GlanceVerdict:
    """One assessment tick's findings."""

    # (job_id, node_id) pairs judged slow, with the assessment that fired.
    slow_nodes: List[Tuple[str, str, str]]  # (job, node, reason)
    # Nodes judged failed by the Eq. 4 monitor.
    failed_nodes: List[str]


class NeighborhoodGlance:
    """Stateful tri-assessment over coordinator snapshots."""

    def __init__(self, node_ids: Sequence[str], cfg: GlanceConfig = GlanceConfig(),
                 topology: Optional[Dict[str, Sequence[str]]] = None,
                 backend: Optional[AssessmentBackend] = None):
        self.cfg = cfg
        self.backend = backend if backend is not None \
            else get_backend(cfg.assess_backend)
        self.node_ids: List[str] = list(node_ids)
        self.node_index = {n: i for i, n in enumerate(self.node_ids)}
        self._neighborhoods = self._build_neighborhoods(topology)
        n = len(self.node_ids)
        # Eq. 2 state per job: {"k": accepted-sample counter, "t": time of
        # the last accepted sample, "prog": {attempt_id: ζ} at that sample
        # (reference path), "hist": Δ-history list of (n_nodes,) arrays}.
        # ζ deltas are computed over attempts alive at BOTH samples — the
        # paper's "only on-going tasks" guard against the end-of-wave
        # ProgressScore decline, done per-attempt so wave transitions can
        # never register as negative acceleration. The vectorized path
        # stores the per-attempt sample membership in two ArraySnapshot
        # scratch columns (sample mark + ζ at mark) instead of "prog".
        self._temporal: Dict[str, dict] = {}
        # Eq. 4 state, array-of-nodes storage shared by both paths:
        # outage-duration history (most recent last), current adaptive
        # threshold, outage bookkeeping (NaN = not currently lost).
        self._outages: Dict[str, List[float]] = {n_: [] for n_ in self.node_ids}
        self._thresholds = np.full(n, cfg.fail_threshold_init)
        self._lost = np.full(n, np.nan)
        self._declared = np.zeros(n, dtype=bool)
        # Debounce state: per (job, node) consecutive Eq. 1 hits
        # (reference path); per-job (n_nodes,) counters (vectorized path).
        self._spatial_streak: Dict[Tuple[str, str], int] = {}
        self._v_streak: Dict[str, np.ndarray] = {}
        # Optional flight recorder (repro_torch.obs): verdict records carrying
        # the Eq. 1–4 inputs at decision time. One branch per fire site.
        self.obs = None

    def _build_neighborhoods(self, topology) -> np.ndarray:
        return build_neighborhoods(self.node_ids, self.cfg.size_neighbor,
                                   topology)

    def neighbors_of(self, node_id: str) -> List[str]:
        row = self._neighborhoods[self.node_index[node_id]]
        return [self.node_ids[i] for i in row if self.node_ids[i] != node_id]

    def threshold_of(self, node_id: str) -> float:
        return float(self._thresholds[self.node_index[node_id]])

    # ------------------------------------------------------------------
    # Assessment tick
    # ------------------------------------------------------------------
    def assess(self, snap: ClusterSnapshot) -> GlanceVerdict:
        arr = getattr(snap, "arrays", None)
        if arr is not None:
            return self._assess_arrays(snap, arr)
        slow: List[Tuple[str, str, str]] = []
        failed = self._assess_failure(snap) if self.cfg.enable_failure else []
        for job_id in snap.job_ids():
            if self.cfg.enable_spatial:
                for node in self._assess_spatial(snap, job_id):
                    slow.append((job_id, node, "spatial"))
            if self.cfg.enable_temporal:
                for node in self._assess_temporal(snap, job_id):
                    slow.append((job_id, node, "temporal"))
        return GlanceVerdict(slow_nodes=slow, failed_nodes=failed)

    # --- Eq. 1 (reference path) ---------------------------------------
    def _assess_spatial(self, snap: ClusterSnapshot, job_id: str) -> List[str]:
        # Assessed PER PHASE: the paper's P(N^J) averages ρ over all of a
        # job's tasks on the node, but map and reduce progress rates differ
        # by an order of magnitude (the dichotomy, §II.B) — mixing them
        # makes every reducer-hosting node look slow. See DESIGN.md §8.
        hits: set = set()
        pstats: Dict[int, Tuple[float, float, float]] = {}
        for kind in (TaskKind.MAP, TaskKind.REDUCE):
            prog, rt, nodes = [], [], []
            for t in snap.tasks.values():
                if t.job_id != job_id or t.state != TaskState.RUNNING \
                        or t.kind != kind:
                    continue
                for a in t.attempts:
                    if a.state != AttemptState.RUNNING:
                        continue
                    prog.append(a.progress)
                    rt.append(max(snap.now - a.start_time, 1e-9))
                    nodes.append(self.node_index[a.node_id])
            if not prog:
                continue
            P = M.node_progress_rate_np(
                np.asarray(prog), np.asarray(rt), np.asarray(nodes),
                len(self.node_ids))
            mask = M.spatial_slow_mask_np(P, self._neighborhoods)
            for i in np.flatnonzero(mask):
                hits.add(self.node_ids[i])
                if self.obs is not None:
                    nh = P[self._neighborhoods[i]]
                    nh = nh[~np.isnan(nh)]
                    mu = float(nh.mean()) if len(nh) else 0.0
                    sd = float(nh.std()) if len(nh) else 0.0
                    pstats[int(i)] = (float(P[i]), mu, sd)
        out = []
        for nid in self.node_ids:
            key = (job_id, nid)
            if nid in hits:
                streak = self._spatial_streak.get(key, 0) + 1
                self._spatial_streak[key] = streak
                if streak >= self.cfg.spatial_consecutive:
                    out.append(nid)
                    if self.obs is not None:
                        i = self.node_index[nid]
                        p, mu, sd = pstats.get(i, (0.0, 0.0, 0.0))
                        self.obs.emit(K_GLANCE_SPATIAL, a=i, b=streak,
                                      f0=p, f1=mu, f2=sd, obj=job_id)
            else:
                self._spatial_streak.pop(key, None)
        return out

    # --- Eq. 2–3 (reference path) -------------------------------------
    def _assess_temporal(self, snap: ClusterSnapshot, job_id: str) -> List[str]:
        n = len(self.node_ids)
        cur: Dict[str, float] = {}
        node_of: Dict[str, int] = {}
        for t in snap.tasks.values():
            if t.job_id != job_id or t.state != TaskState.RUNNING:
                continue
            for a in t.attempts:
                if a.state == AttemptState.RUNNING:
                    cur[a.attempt_id] = a.progress
                    node_of[a.attempt_id] = self.node_index[a.node_id]
        prev = self._temporal.get(job_id)
        if prev is None:
            self._temporal[job_id] = {
                "k": 0, "t": snap.now, "prog": cur, "hist": []}
            return []
        dt = snap.now - prev["t"]
        if dt < self.cfg.temporal_period:
            return []
        prev_prog, history = prev["prog"], prev["hist"]
        # ζ delta per node over attempts alive at both samples.
        zeta_now = np.full(n, np.nan)
        zeta_prev = np.full(n, np.nan)
        for aid, p in cur.items():
            if aid not in prev_prog:
                continue
            i = node_of[aid]
            if np.isnan(zeta_now[i]):
                zeta_now[i] = 0.0
                zeta_prev[i] = 0.0
            zeta_now[i] += p
            zeta_prev[i] += prev_prog[aid]
        slow_mask, delta_now = self._temporal_step(
            history, zeta_now, zeta_prev, dt)
        prev.update(k=prev["k"] + 1, t=snap.now, prog=cur)
        return [self.node_ids[i] for i in np.flatnonzero(slow_mask)]

    def _temporal_step(self, history: List[np.ndarray], zeta_now, zeta_prev,
                       dt: float):
        """Shared Eq. 2–3 core: peak-hold reference over the recent window,
        strict-ratio slowdown test, history update."""
        n = len(self.node_ids)
        if history:
            stacked = np.stack(history)
            any_valid = ~np.isnan(stacked).all(axis=0)
            filled = np.where(np.isnan(stacked), -np.inf, stacked)
            delta_ref = np.where(any_valid, filled.max(axis=0), np.nan)
        else:
            delta_ref = np.full(n, np.nan)
        slow_mask, delta_now = M.temporal_slow_mask_np(
            zeta_now, zeta_prev, dt, delta_ref,
            threshold_slowdown=self.cfg.threshold_slowdown)
        if self.obs is not None:
            for i in np.flatnonzero(slow_mask):
                self.obs.emit(K_GLANCE_TEMPORAL, a=int(i),
                              f0=float(delta_now[i]),
                              f1=float(delta_ref[i]), f2=dt,
                              f3=self.cfg.threshold_slowdown)
        history.append(delta_now)
        del history[:-self.cfg.temporal_window]
        return slow_mask, delta_now

    # --- Eq. 4 (reference path) ---------------------------------------
    def _assess_failure(self, snap: ClusterSnapshot) -> List[str]:
        newly_failed: List[str] = []
        for nid, node in snap.nodes.items():
            i = self.node_index.get(nid)
            if i is None:
                continue
            silent = snap.now - node.last_heartbeat
            lost_at = self._lost[i]
            if silent <= self.cfg.responsive_window:  # responsive this tick
                if not np.isnan(lost_at):
                    # A resuming heartbeat from a previously lost node:
                    # record the outage duration R_n and adapt (Eq. 4).
                    outage = snap.now - lost_at
                    self._record_outage(nid, outage)
                    self._lost[i] = np.nan
                self._declared[i] = False
                continue
            if np.isnan(lost_at):
                self._lost[i] = node.last_heartbeat
            if self._declared[i] or node.marked_failed:
                continue
            if silent > self._thresholds[i]:
                self._declared[i] = True
                newly_failed.append(nid)
                if self.obs is not None:
                    self.obs.emit(K_GLANCE_FAIL, a=i, f0=silent,
                                  f1=float(self._thresholds[i]),
                                  f2=silent - float(self._thresholds[i]))
        return newly_failed

    def _record_outage(self, node_id: str, duration: float) -> None:
        hist = self._outages[node_id]
        hist.append(duration)
        L = self.cfg.failure_window
        del hist[:-L]
        est = M.eq4_estimate_np(hist, L)
        if est is not None:
            i = self.node_index[node_id]
            self._thresholds[i] = float(np.clip(
                est * self.cfg.fail_threshold_margin,
                self.cfg.fail_threshold_min, self.cfg.fail_threshold_max))
            if self.obs is not None:
                self.obs.emit(K_THRESH, a=i, b=len(hist),
                              f0=float(self._thresholds[i]), f1=duration,
                              f2=float(est))

    # Substrate hook: a node confirmed dead externally resets its streak so a
    # replacement with the same id starts from the configured default.
    def reset_node(self, node_id: str) -> None:
        i = self.node_index[node_id]
        self._lost[i] = np.nan
        self._declared[i] = False

    # ==================================================================
    # Vectorized path (columnar snapshots)
    # ==================================================================
    def _assess_arrays(self, snap: ClusterSnapshot, arr) -> GlanceVerdict:
        now = snap.now
        failed = (self._assess_failure_arrays(now, arr)
                  if self.cfg.enable_failure else [])
        active = arr.active_jobs()
        J = len(active)
        spatial_fire = temporal_fire = None
        if J and (self.cfg.enable_spatial or self.cfg.enable_temporal):
            if self.cfg.enable_spatial:
                spatial_fire = self._spatial_arrays(now, arr, active)
            if self.cfg.enable_temporal:
                temporal_fire = self._temporal_arrays(now, arr, active)
        slow: List[Tuple[str, str, str]] = []
        for pos, (jid, _jidx) in enumerate(active):
            if spatial_fire is not None:
                for i in np.flatnonzero(spatial_fire[pos]):
                    slow.append((jid, self.node_ids[i], "spatial"))
            if temporal_fire is not None:
                for i in np.flatnonzero(temporal_fire[pos]):
                    slow.append((jid, self.node_ids[i], "temporal"))
        return GlanceVerdict(slow_nodes=slow, failed_nodes=failed)

    # --- Eq. 1, all jobs × both phases in one backend pass -------------
    def _spatial_arrays(self, now: float, arr, active) -> np.ndarray:
        n = len(self.node_ids)
        J = len(active)
        hits = self.backend.spatial_hits(arr, now, active,
                                         self._neighborhoods)
        fire = np.zeros((J, n), dtype=bool)
        for pos, (jid, _jidx) in enumerate(active):
            streak = self._v_streak.get(jid)
            if streak is None:
                streak = np.zeros(n, dtype=np.int64)
                self._v_streak[jid] = streak
            streak[:] = np.where(hits[pos], streak + 1, 0)
            fire[pos] = streak >= self.cfg.spatial_consecutive
            if self.obs is not None:
                # Vectorized path: the backend consumed the P values; the
                # verdict record carries the streak only (§18.2 waiver).
                for i in np.flatnonzero(fire[pos]):
                    self.obs.emit(K_GLANCE_SPATIAL, a=int(i),
                                  b=int(streak[i]), obj=jid)
        if len(self._v_streak) > 2 * J + 16:  # shed completed jobs' state
            keep = {jid for jid, _ in active}
            self._v_streak = {j: s for j, s in self._v_streak.items()
                              if j in keep}
        return fire

    # --- Eq. 2–3, per-attempt work batched across all sampled jobs -----
    def _temporal_arrays(self, now: float, arr, active) -> np.ndarray:
        n = len(self.node_ids)
        J = len(active)
        fire = np.zeros((J, n), dtype=bool)
        init_flag = np.zeros(J, dtype=bool)
        samp_flag = np.zeros(J, dtype=bool)
        prevk = np.full(J, -2, dtype=np.int64)
        states = []
        for pos, (jid, _jidx) in enumerate(active):
            st = self._temporal.get(jid)
            if st is None:
                st = {"k": 0, "t": now, "hist": []}
                self._temporal[jid] = st
                init_flag[pos] = True
            elif now - st["t"] >= self.cfg.temporal_period:
                samp_flag[pos] = True
                prevk[pos] = st["k"]
            states.append(st)
        zeta_now, zeta_prev = self.backend.temporal_zeta(
            arr, now, active, samp_flag, init_flag, prevk)
        for pos in np.flatnonzero(samp_flag):
            st = states[pos]
            dt = now - st["t"]
            slow_mask, _ = self._temporal_step(
                st["hist"], zeta_now[pos], zeta_prev[pos], dt)
            st["k"] += 1
            st["t"] = now
            fire[pos] = slow_mask
        return fire

    # --- Eq. 4, whole-cluster array ops --------------------------------
    def _assess_failure_arrays(self, now: float, arr) -> List[str]:
        resp, cand = self.backend.failure_masks(
            now, arr.node_hb, arr.node_marked, self._declared,
            self._thresholds, self.cfg.responsive_window)
        resumed = resp & ~np.isnan(self._lost)
        for i in np.flatnonzero(resumed):
            # A resuming heartbeat from a previously lost node (rare):
            # record the outage duration R_n and adapt (Eq. 4).
            self._record_outage(self.node_ids[i], now - self._lost[i])
        self._lost[resp] = np.nan
        self._declared[resp] = False
        newlost = ~resp & np.isnan(self._lost)
        self._lost[newlost] = arr.node_hb[newlost]
        self._declared[cand] = True
        out = [self.node_ids[i] for i in np.flatnonzero(cand)]
        if self.obs is not None:
            for i in np.flatnonzero(cand):
                silent = now - float(arr.node_hb[i])
                self.obs.emit(K_GLANCE_FAIL, a=int(i), f0=silent,
                              f1=float(self._thresholds[i]),
                              f2=silent - float(self._thresholds[i]))
        return out
