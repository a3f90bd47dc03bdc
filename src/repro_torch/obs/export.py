"""Trace exporters + diff tooling (DESIGN.md §18.4).

``to_chrome_trace`` renders a :class:`~repro_torch.obs.trace.TraceRecorder`
into the Chrome trace-event JSON format, loadable in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing`` — attempts become
duration slices on their node's track, everything else becomes instant
events. ``trace_diff`` compares two recorders record-for-record, the
trace-plane sibling of the action-trace equivalence gate.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.obs.trace import (
    K_ATT_END,
    K_ATT_START,
    K_DRAIN,
    KIND_NAMES,
    TraceRecorder,
)

_US = 1e6  # chrome trace timestamps are microseconds


def to_chrome_trace(rec: TraceRecorder, *,
                    node_names: Optional[Sequence[str]] = None,
                    process_name: str = "repro") -> Dict[str, Any]:
    """Render the recorder into a chrome://tracing / Perfetto document.

    Tracks (``tid``) are node indices; attempt lifecycle records pair
    into complete ("X") slices keyed by attempt id, drains become slices
    on a dedicated engine track, and every other kind becomes an instant
    ("i") event carrying its numeric fields as args."""
    events: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
        "args": {"name": process_name},
    }]
    if node_names:
        for i, nid in enumerate(node_names):
            events.append({"name": "thread_name", "ph": "M", "pid": 0,
                           "tid": i, "args": {"name": str(nid)}})
    open_attempts: Dict[Any, Any] = {}
    for r, obj in rec.iter_with_objs():
        kind = int(r["kind"])
        t_us = float(r["time"]) * _US
        a = int(r["a"])
        if kind == K_ATT_START:
            open_attempts[obj] = (t_us, a, int(r["b"]))
        elif kind == K_ATT_END:
            start = open_attempts.pop(obj, None)
            t0 = start[0] if start is not None else float(r["f0"]) * _US
            events.append({
                "name": str(obj), "cat": "attempt", "ph": "X",
                "pid": 0, "tid": a, "ts": t0,
                "dur": max(t_us - t0, 0.0),
                "args": {"state": int(r["b"]),
                         "work": float(r["f1"]),
                         "speculative": bool(r["f2"])},
            })
        elif kind == K_DRAIN:
            t0 = float(r["f0"]) * _US
            events.append({
                "name": "drain", "cat": "engine", "ph": "X",
                "pid": 1, "tid": 0, "ts": t0,
                "dur": max(t_us - t0, 0.0),
                "args": {"records": int(r["b"])},
            })
        else:
            args = {"a": a, "b": int(r["b"]),
                    "f0": float(r["f0"]), "f1": float(r["f1"]),
                    "f2": float(r["f2"]), "f3": float(r["f3"])}
            if obj is not None:
                args["obj"] = repr(obj)
            events.append({
                "name": KIND_NAMES.get(kind, str(kind)),
                "cat": "obs", "ph": "i", "s": "g",
                "pid": 0, "tid": max(a, 0), "ts": t_us, "args": args,
            })
    # attempts still open at export time: emit as zero-duration starts
    for obj, (t0, a, flags) in open_attempts.items():
        events.append({"name": str(obj), "cat": "attempt", "ph": "X",
                       "pid": 0, "tid": a, "ts": t0, "dur": 0.0,
                       "args": {"state": 0, "flags": flags}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"dropped_records": rec.dropped}}


def write_chrome_trace(rec: TraceRecorder, path: str, **kw) -> str:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(rec, **kw), f)
    return path


def trace_diff(a: TraceRecorder, b: TraceRecorder, *,
               kinds: Optional[Sequence[int]] = None,
               time_tol: float = 0.0) -> Dict[str, Any]:
    """Record-for-record comparison of two traces.

    Compares ``(kind, a, b, f0..f3)`` plus (within ``time_tol``) the
    timestamps, ignoring ``seq``/``o`` (recorder-local). Returns a
    summary dict; ``equal`` is True when both streams match end to end.
    Restrict to ``kinds`` to diff one plane (e.g. only actions)."""
    ra, rb = a.records(), b.records()
    if kinds is not None:
        import numpy as np
        ra = ra[np.isin(ra["kind"], list(kinds))]
        rb = rb[np.isin(rb["kind"], list(kinds))]
    n = min(len(ra), len(rb))
    first = None
    for i in range(n):
        x, y = ra[i], rb[i]
        same = (int(x["kind"]) == int(y["kind"])
                and int(x["a"]) == int(y["a"])
                and int(x["b"]) == int(y["b"])
                and abs(float(x["time"]) - float(y["time"])) <= time_tol
                and all(float(x[f]) == float(y[f])
                        for f in ("f0", "f1", "f2", "f3")))
        if not same:
            first = i
            break
    equal = first is None and len(ra) == len(rb)
    out = {"equal": equal, "n_a": len(ra), "n_b": len(rb),
           "first_diff": first}
    if first is not None:
        out["detail"] = (f"record {first}: "
                         f"a={_fmt(ra[first])} b={_fmt(rb[first])}")
    elif len(ra) != len(rb):
        out["detail"] = f"length mismatch: {len(ra)} vs {len(rb)}"
    return out


def _fmt(r) -> str:
    name = KIND_NAMES.get(int(r["kind"]), str(int(r["kind"])))
    return (f"{name}(t={float(r['time']):.4f}, a={int(r['a'])}, "
            f"b={int(r['b'])}, f0={float(r['f0']):.4g})")
