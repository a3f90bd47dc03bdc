"""Speculation scorecard: detection quality from a flight-recorder trace
(DESIGN.md §18.5).

The chaos/fault scripts give perfect ground truth — every injected
node fault lands as a ``K_FAULT`` record at its actual fire time, with
the victim's node index. Policy failure verdicts land as ``K_DETECT``
records (``b=1`` policy-marked via Eq. 4 / MarkNodeFailed, ``b=0``
liveness-expiry declared). Joining the two planes yields the
scheduler-survey detection metrics no per-run counter could produce:

- **precision** — of the nodes a policy declared failed, how many were
  actually faulted;
- **recall** — of the faulted nodes, how many the policy caught;
- **time-to-detect** — first detection minus injection, per victim
  (clock-relative: sim seconds in the simulator, virtual Clock seconds
  in the runtime — comparable within a world, waived across worlds,
  §18.5);
- **wasted backup work** — work sunk into speculative attempts that
  lost their race (ended KILLED/FAILED).

``mode="mark"`` restricts detections to node-failure verdicts — the
cross-world comparable core (sim and FakeClock runtime traces of the
same script must agree on tp/fp/fn and precision/recall;
tests/test_obs.py pins this). ``mode="any"`` additionally counts
straggler speculations/kills against the slow node as detections —
the right lens for slowdown faults, where no failure verdict ever
fires.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from repro_torch.obs.trace import (
    END_COMPLETED,
    END_FAILED,
    END_KILLED,
    K_ACTION,
    K_ATT_END,
    K_DETECT,
    K_FAULT,
    NODE_FAULT_CODES,
    TraceRecorder,
)


def attempt_outcomes(rec: TraceRecorder) -> List[Dict[str, Any]]:
    """Per-attempt ground-truth table from the lifecycle + fault planes.

    One row per ``K_ATT_END`` record, in emission order, classified
    against the injected node faults:

    - ``failed`` — the attempt ended FAILED (its node died under it);
    - ``straggled`` — the attempt was reaped (ended KILLED — a sibling
      won its race) on a node that had a fault injected before it
      ended. The fault anchor matters: a KILLED attempt on a
      never-faulted node merely *lost a race* (the winner launched
      later and tied-or-beat it on equal hardware) and is ``clean`` —
      labeling those as stragglers teaches a predictor that every
      long-running tail task is slow (DESIGN.md §20);
    - ``clean`` — everything else.

    Exactly one of the three flags is set per row. This is the single
    labeling code path shared by predictor dataset generation
    (repro_torch.predict.dataset) and the scorecard's wasted-backup
    accounting — post-hoc trace joins only, never tick-time state
    (DESIGN.md §20 leakage rule).
    """
    victims: Dict[int, float] = {}
    for r in rec.by_kind(K_FAULT):
        if int(r["b"]) in NODE_FAULT_CODES and int(r["a"]) >= 0:
            victims.setdefault(int(r["a"]), float(r["time"]))
    rows: List[Dict[str, Any]] = []
    for r, aid in rec.iter_with_objs(K_ATT_END):
        node = int(r["a"])
        end_code = int(r["b"])
        end = float(r["time"])
        fault_time: Optional[float] = victims.get(node)
        on_faulted = fault_time is not None and fault_time <= end
        failed = end_code == END_FAILED
        straggled = not failed and end_code == END_KILLED and on_faulted
        rows.append({
            "attempt_id": aid,
            "node": node,
            "end_code": end_code,
            "start": float(r["f0"]),
            "end": end,
            "work": float(r["f1"]),
            "speculative": bool(float(r["f2"])),
            "fault_time": fault_time if on_faulted else None,
            "failed": failed,
            "straggled": straggled,
            "clean": not failed and not straggled,
        })
    return rows


def scorecard(rec: TraceRecorder, *, policy: str = "",
              mode: str = "mark") -> Dict[str, Any]:
    """Join fault ground truth against detection records."""
    if mode not in ("mark", "any"):
        raise ValueError(f"unknown scorecard mode: {mode}")
    # ground truth: first injection time per node victim
    victims: Dict[int, float] = {}
    n_faults = 0
    for r in rec.by_kind(K_FAULT):
        n_faults += 1
        if int(r["b"]) in NODE_FAULT_CODES and int(r["a"]) >= 0:
            victims.setdefault(int(r["a"]), float(r["time"]))
    # detections: first verdict time per node
    detections: Dict[int, float] = {}
    for r in rec.by_kind(K_DETECT):
        detections.setdefault(int(r["a"]), float(r["time"]))
    n_speculations = 0
    for r in rec.by_kind(K_ACTION):
        if int(r["b"]) != 1:  # ACT_MARK_FAILED already covered by detect
            n_speculations += 1
            if mode == "any" and int(r["a"]) >= 0:
                detections.setdefault(int(r["a"]), float(r["time"]))
    tp = sorted(set(victims) & set(detections))
    fp = sorted(set(detections) - set(victims))
    fn = sorted(set(victims) - set(detections))
    # vacuous cases score 1.0: no detections ⇒ nothing falsely accused,
    # no victims ⇒ nothing missed
    precision = len(tp) / (len(tp) + len(fp)) if detections else 1.0
    recall = len(tp) / (len(tp) + len(fn)) if victims else 1.0
    ttd = {i: detections[i] - victims[i] for i in tp}
    wasted = 0.0
    n_backups = 0
    for o in attempt_outcomes(rec):
        if o["speculative"]:
            n_backups += 1
            if o["end_code"] != END_COMPLETED:
                wasted += o["work"]
    return {
        "policy": policy,
        "mode": mode,
        "n_faults": n_faults,
        "victims": sorted(victims),
        "tp": tp,
        "fp": fp,
        "fn": fn,
        "precision": round(precision, 6),
        "recall": round(recall, 6),
        "ttd": {int(k): round(v, 6) for k, v in sorted(ttd.items())},
        "mean_ttd": round(sum(ttd.values()) / len(ttd), 6) if ttd
        else None,
        "n_speculations": n_speculations,
        "n_backups": n_backups,
        "wasted_backup_work": round(wasted, 6),
    }


def comparable_core(card: Dict[str, Any]) -> Dict[str, Any]:
    """The cross-world-identical subset of a scorecard: index sets and
    ratios only — time-to-detect and work are clock-relative and waived
    across worlds (DESIGN.md §18.5)."""
    return {k: card[k] for k in
            ("victims", "tp", "fp", "fn", "precision", "recall")}
