"""repro_torch.obs — the flight recorder's trace schema and the metrics
plane (DESIGN.md §18).

Ported: :mod:`repro_torch.obs.trace` (the simulator's and the runtime's
emit sites need its record kinds and :class:`TraceRecorder`) and
:mod:`repro_torch.obs.metrics` (the live coordinator counts its recovery
work in a :class:`MetricsRegistry`). The exporters and scorecards wait
(ROADMAP).
"""
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Timer,
    instrument_drain,
)
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
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Timer",
    "instrument_drain",
    "ACT_KILL", "ACT_MARK_FAILED", "ACT_SPECULATE", "END_COMPLETED",
    "END_FAILED", "END_KILLED", "FAULT_CODES", "K_ACTION", "K_ATT_END",
    "K_ATT_START", "K_BUDGET", "K_CHECKPOINT", "K_DETECT", "K_DISPATCH",
    "K_DRAIN", "K_FAULT", "K_FETCH_FAIL", "K_FLOW_BULK", "K_FLOW_CLOSE",
    "K_FLOW_OPEN", "K_GLANCE_FAIL", "K_GLANCE_SPATIAL",
    "K_GLANCE_TEMPORAL", "K_LATE", "K_PREDICT", "K_RAMP", "K_ROLLBACK",
    "K_THRESH", "KIND_NAMES", "NODE_FAULT_CODES", "TRACE_DTYPE",
    "TraceRecorder",
]
