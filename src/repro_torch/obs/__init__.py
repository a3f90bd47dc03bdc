"""repro_torch.obs — flight recorder, metrics plane, exporters, scorecards
(DESIGN.md §18).

One trace schema, two worlds: the simulator and the live runtime emit
identical structured-numpy records through a :class:`TraceRecorder`
(one ``is not None`` branch per site when absent), the
:class:`MetricsRegistry` counts the coordinator's recovery work, and the
exporters and scorecard turn traces into Perfetto timelines and
detection-quality numbers. All of it is numpy and Python, copied from
the reference package; nothing here touches the card.
"""
from repro_torch.obs.export import to_chrome_trace, trace_diff, \
    write_chrome_trace
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Timer,
    instrument_drain,
)
from repro_torch.obs.scorecard import attempt_outcomes, comparable_core, \
    scorecard
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
    "to_chrome_trace", "write_chrome_trace", "trace_diff",
    "scorecard", "comparable_core", "attempt_outcomes",
]
