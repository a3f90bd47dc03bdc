"""Batched multi-scenario assessment sweeps (DESIGN.md §13.4).

Speculation policies are compared across *many* fault scenarios — the
multi-job speculative-execution literature scores a policy by sweeping
fault grids, and the ROADMAP's assess-bound sweeps re-run the same
per-tick reductions once per scenario. :class:`BatchedSweep` instead
stacks N perturbed copies of the §11 columns along a leading scenario
axis and scores one whole assessment step for all of them at once: one
upload, the torch backend's prep over (N, cap) columns, and one launch
each of kernels B1, B3 and B4 (:mod:`repro_torch.accel.kernels`) with a
scenario grid axis — amortizing both the Python tick overhead and the
kernel launch cost N ways.

Scenario kinds mirror the :mod:`repro_torch.sim.faults` injectors, as
column perturbations rather than event-schedule edits:

- ``crash``    — victim node's clock stops and heartbeats go silent
  (Eq. 4 territory; frozen ζ drags Eq. 1/LATE);
- ``delay``    — victim node slowed to ``factor`` (Eq. 1/Eq. 3 territory);
- ``mof_loss`` — a few reducers lose an already-fetched map output and
  burn a failure cycle (shuffle-health regression);
- ``fetch_quorum`` — every running reducer regresses one partition with
  stacked failure cycles (the AM-quorum stall shape);
- ``rack_degrade`` — a sick rack switch (with ``n_racks > 1``).

``run_serial`` evaluates the identical clones one at a time on the
numpy reference backend — the baseline, and the parity oracle for
``run_batched`` (bit-exact, on the CPU and on the card).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.accel.base import TMARK, TPROG
from repro_torch.accel.numpy_backend import NumpyBackend
from repro_torch.accel.torch_backend import (
    _UPLOAD,
    failure_core,
    late,
    late_inputs,
    neighborhood_tensor,
    prep,
    reap,
    reap_inputs,
    require_device,
    spatial,
    spatial_inputs,
)
from repro_torch.core.arrays import ArraySnapshot, DeviceColumns

__all__ = ["Scenario", "scenario_grid", "apply_scenario", "BatchedSweep"]

# Stacked per-scenario columns: the attempt columns prep reads, without
# the Eq. 2 scratch (one step holds no ζ delta), plus the node columns.
_SWEEP_COLS = tuple(c for c in _UPLOAD if c not in (TMARK, TPROG)) \
    + ("node_speed", "node_hb", "node_marked")


@dataclasses.dataclass(frozen=True)
class Scenario:
    kind: str            # baseline | crash | delay | mof_loss |
    #                      fetch_quorum | rack_degrade
    node: int = -1       # victim node index (crash / delay)
    factor: float = 1.0  # speed multiplier (delay) / uplink factor
    width: int = 2       # reducers hit (mof_loss)
    silent_s: float = 12.0   # heartbeat silence injected (crash)
    rack: int = -1       # victim rack (rack_degrade; §15 net columns)


def scenario_grid(n_scenarios: int, n_nodes: int,
                  seed: int = 0, n_racks: int = 1) -> List[Scenario]:
    """A deterministic grid cycling the fault kinds over distinct
    victims/intensities — the sweep analogue of the benchmark fault
    grids (benches × fracs × seeds). With a rack topology
    (``n_racks > 1``) the cycle includes ``rack_degrade`` — the
    degraded-uplink shape driven from the §15 ``node_rack`` column."""
    rng = np.random.default_rng(seed)
    kinds = ("crash", "delay", "mof_loss", "fetch_quorum")
    if n_racks > 1:
        kinds = kinds + ("rack_degrade",)
    out: List[Scenario] = []
    for i in range(n_scenarios):
        kind = kinds[i % len(kinds)]
        node = int(rng.integers(0, n_nodes))
        k = len(kinds)
        if kind == "crash":
            out.append(Scenario(kind, node=node,
                                silent_s=float(11 + 7 * (i // k % 3))))
        elif kind == "delay":
            out.append(Scenario(kind, node=node,
                                factor=float(0.02 + 0.03 * (i // k % 3))))
        elif kind == "mof_loss":
            out.append(Scenario(kind, width=1 + i // k % 3))
        elif kind == "rack_degrade":
            out.append(Scenario(kind, rack=int(rng.integers(0, n_racks)),
                                factor=float(0.02 + 0.04 * (i // k % 3))))
        else:
            out.append(Scenario(kind))
    return out


def apply_scenario(arr: ArraySnapshot, sc: Scenario, now: float) -> None:
    """Perturb a cloned snapshot in place (host numpy)."""
    if sc.kind == "baseline":
        return
    if sc.kind == "crash":
        v = sc.node % len(arr.node_ids)
        arr.node_speed[v] = 0.0
        arr.node_hb[v] = now - sc.silent_s
        return
    if sc.kind == "delay":
        v = sc.node % len(arr.node_ids)
        arr.node_speed[v] = sc.factor
        return
    n = arr.n
    reducing = np.flatnonzero(
        arr.active[:n] & (arr.kind[:n] == 1) & (arr.a_state[:n] == 0)
        & (arr.fetched[:n] > 0))
    if sc.kind == "mof_loss":
        hit = reducing[:sc.width]
        arr.fetched[hit] -= 1
        arr.sh_fail[hit] += 1
    elif sc.kind == "rack_degrade":
        # Sick rack switch (§15 net columns): every running reducer
        # hosted in the rack sees its shuffle health sag — transfers
        # stall (inflight drains into failure pressure) and fetched
        # partitions regress, more of them the sicker the uplink — while
        # node clocks and heartbeats stay perfectly healthy. The
        # glance's ζ must attribute this to the rack's fetch plane, not
        # to any single node. (``rack_factor`` documents the scenario on
        # the clone; the assessment-visible perturbation is the
        # severity-scaled shuffle columns.)
        # len(rack_factor) IS the topology's rack count (aliased from
        # the net model) — node_rack.max()+1 would diverge from the
        # live fault path whenever ceil-division leaves trailing racks
        # empty (an empty victim rack perturbs nothing, same as live).
        rack = sc.rack % max(1, len(arr.rack_factor))
        arr.rack_factor[rack] = max(sc.factor, 1e-3)
        severity = 1 + int(sc.factor < 0.05)
        hit = reducing[arr.node_rack[arr.node[reducing]] == rack]
        arr.fetched[hit] = np.maximum(arr.fetched[hit] - severity, 0)
        arr.sh_fail[hit] += severity
        arr.sh_inflight[hit] = 0
    else:  # fetch_quorum: every running reducer regresses one partition
        arr.fetched[reducing] -= 1
        arr.sh_fail[reducing] += 2
        arr.sh_inflight[reducing] = 0


class BatchedSweep:
    """One assessment step × N fault scenarios, in one batched pass.

    ``prepare`` clones the live snapshot once per scenario and applies
    the perturbation; ``run_batched`` stacks the padded mirrors and
    scores every scenario with one launch each of B1, B3 and B4;
    ``run_serial`` walks the same clones on the numpy backend (the
    baseline / parity oracle)."""

    def __init__(self, arr: ArraySnapshot, now: float, *,
                 neighborhoods: Optional[np.ndarray] = None,
                 min_runtime: float = 10.0,
                 slow_task_percentile: float = 25.0,
                 win_factor: float = 1.0,
                 fail_threshold: float = 10.0,
                 responsive_window: float = 1.5):
        self.arr = arr
        self.now = float(now)
        n = len(arr.node_ids)
        if neighborhoods is None:
            from repro_torch.core.glance import build_neighborhoods
            neighborhoods = build_neighborhoods(arr.node_ids)
        self.neighborhoods = np.asarray(neighborhoods, dtype=np.int64)
        self.min_runtime = min_runtime
        self.slow_task_percentile = slow_task_percentile
        self.win_factor = win_factor
        self.thresholds = np.full(n, fail_threshold)
        self.declared = np.zeros(n, dtype=bool)
        self.responsive_window = responsive_window
        self.active = arr.active_jobs()
        self.clones: List[ArraySnapshot] = []
        self._stacked: Optional[Dict[str, np.ndarray]] = None
        self._jcap = 0

    # ------------------------------------------------------------------
    def prepare(self, scenarios: Sequence[Scenario]) -> "BatchedSweep":
        self.clones = []
        stacked: Dict[str, List[np.ndarray]] = {}
        jcap = 0
        for sc in scenarios:
            clone = self.arr.clone_for_assessment()
            apply_scenario(clone, sc, self.now)
            self.clones.append(clone)
            dc = DeviceColumns(clone)
            host = dc.refresh(self.active)
            jcap = max(jcap, dc.jcap)
            for k in _SWEEP_COLS + ("n_rows",):
                stacked.setdefault(k, []).append(np.asarray(host[k]))
        self._jcap = max(jcap, DeviceColumns.MIN_JOBS)
        self._stacked = {k: np.stack(v) for k, v in stacked.items()}
        return self

    # ------------------------------------------------------------------
    def kernel_args(self, device: Optional[str] = None) -> tuple:
        """Upload the stacked columns to ``device`` (default the CUDA
        card, which raises when absent) and prepare them: returns the
        batched kernels' arguments by name (``spatial``, ``late``,
        ``reap``; ``chip_smoke.py`` times the kernels on exactly these)
        and the uploaded columns."""
        if self._stacked is None:
            raise RuntimeError("call prepare() first")
        dev = require_device(device or "cuda", "BatchedSweep")
        now, jcap = self.now, self._jcap
        cols = {k: torch.from_numpy(self._stacked[k]).to(dev)
                for k in _SWEEP_COLS}
        cols["n_rows"] = torch.from_numpy(
            self._stacked["n_rows"].astype(np.int64)).to(dev)[:, None]
        p = prep(cols, now)
        nh = neighborhood_tensor(self.neighborhoods, dev)
        args = {"spatial": spatial_inputs(p, now, nh, jcap),
                "late": late_inputs(p, now, self.min_runtime,
                                    self.slow_task_percentile,
                                    self.win_factor, jcap),
                "reap": reap_inputs(p)}
        return args, cols

    def run_batched(self, device: Optional[str] = None
                    ) -> List[Dict[str, np.ndarray]]:
        """All scenarios in one batched step on ``device`` (default the
        CUDA card, which raises when absent; ``"cpu"`` runs the kernels'
        plain versions): one launch each of B1, B3 and B4. B3's one
        launch gives both the LATE victims and the collective's winning
        verdicts (winning reads neither ``min_runtime`` nor the
        percentile)."""
        args, cols = self.kernel_args(device)
        dev = cols["order"].device
        J = len(self.active)
        fired = spatial(*args["spatial"])
        victims, win = late(*args["late"])
        n_reap = reap(*args["reap"]).sum(dim=1)
        _resp, failed = failure_core(
            self.now, cols["node_hb"], cols["node_marked"],
            torch.from_numpy(self.declared).to(dev),
            torch.from_numpy(self.thresholds).to(dev),
            self.responsive_window)
        host = {"spatial_hits": fired.any(dim=2)[:, :J], "failed": failed,
                "late_victims": victims[:, :J].long(),
                "winning": win[:, :J].bool(), "n_reap": n_reap}
        host = {k: v.cpu().numpy() for k, v in host.items()}
        return [
            {
                "spatial_hits": host["spatial_hits"][i],
                "failed": host["failed"][i],
                "late_victims": host["late_victims"][i],
                "winning": host["winning"][i],
                "n_reap": int(host["n_reap"][i]),
            }
            for i in range(len(self.clones))
        ]

    # ------------------------------------------------------------------
    def run_serial(self) -> List[Dict[str, np.ndarray]]:
        """The same clones, one at a time, on the numpy reference — the
        baseline and the parity oracle of :meth:`run_batched`."""
        if not self.clones:
            raise RuntimeError("call prepare() first")
        out = []
        J = len(self.active)
        eligible = np.ones(J, dtype=bool)
        for clone in self.clones:
            b = NumpyBackend()
            hits = b.spatial_hits(clone, self.now, self.active,
                                  self.neighborhoods)
            _resp, cand = b.failure_masks(
                self.now, clone.node_hb, clone.node_marked, self.declared,
                self.thresholds, self.responsive_window)
            victims = b.late_victims(clone, self.now, self.active,
                                     eligible, self.min_runtime,
                                     self.slow_task_percentile)
            winning = np.array(
                [b.winning(clone, self.now, jidx, self.win_factor)
                 for _jid, jidx in self.active], dtype=bool)
            out.append({
                "spatial_hits": hits,
                "failed": cand,
                "late_victims": victims,
                "winning": winning,
                "n_reap": len(b.reap_rows(clone, self.now)),
            })
        return out
