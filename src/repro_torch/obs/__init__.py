"""repro_torch.obs — the flight recorder's trace schema (DESIGN.md §18).

Only :mod:`repro_torch.obs.trace` is ported: the simulator's emit sites
need its record kinds and :class:`TraceRecorder`. The metrics plane,
exporters and scorecards wait (ROADMAP).
"""
from repro_torch.obs.trace import (
    ACT_KILL,
    ACT_MARK_FAILED,
    ACT_SPECULATE,
    END_COMPLETED,
    END_FAILED,
    END_KILLED,
    FAULT_CODES,
    K_ACTION,
    K_ATT_END,
    K_ATT_START,
    K_BUDGET,
    K_CHECKPOINT,
    K_DETECT,
    K_DISPATCH,
    K_DRAIN,
    K_FAULT,
    K_FETCH_FAIL,
    K_FLOW_BULK,
    K_FLOW_CLOSE,
    K_FLOW_OPEN,
    K_GLANCE_FAIL,
    K_GLANCE_SPATIAL,
    K_GLANCE_TEMPORAL,
    K_LATE,
    K_PREDICT,
    K_RAMP,
    K_ROLLBACK,
    K_THRESH,
    KIND_NAMES,
    NODE_FAULT_CODES,
    TRACE_DTYPE,
    TraceRecorder,
)

__all__ = [
    "ACT_KILL", "ACT_MARK_FAILED", "ACT_SPECULATE", "END_COMPLETED",
    "END_FAILED", "END_KILLED", "FAULT_CODES", "K_ACTION", "K_ATT_END",
    "K_ATT_START", "K_BUDGET", "K_CHECKPOINT", "K_DETECT", "K_DISPATCH",
    "K_DRAIN", "K_FAULT", "K_FETCH_FAIL", "K_FLOW_BULK", "K_FLOW_CLOSE",
    "K_FLOW_OPEN", "K_GLANCE_FAIL", "K_GLANCE_SPATIAL",
    "K_GLANCE_TEMPORAL", "K_LATE", "K_PREDICT", "K_RAMP", "K_ROLLBACK",
    "K_THRESH", "KIND_NAMES", "NODE_FAULT_CODES", "TRACE_DTYPE",
    "TraceRecorder",
]
