"""Binocular speculation — the paper's contribution as a reusable policy
engine (see DESIGN.md §2 for the MapReduce → TPU-training mapping).

Layout:
- ``types``       control-plane snapshot/action protocol
- ``arrays``      columnar (struct-of-arrays) snapshot mirror — the
                  vectorized assessment hot path (DESIGN.md §11)
- ``metrics``     Eq. 1–4 math (numpy + jax mirrors)
- ``glance``      neighborhood glance: spatial/temporal/failure assessments
- ``collective``  collective speculation ramp (COLL_INIT_NUM/COLL_MULTIPLY)
- ``dependency``  dependency-aware re-execution of completed producers
- ``rollback``    speculative rollback from lightweight progress logs
- ``speculator``  BinocularSpeculator + YarnLateSpeculator (baseline)
"""
from repro_torch.core.arrays import ArraySnapshot
from repro_torch.core.collective import CollectiveConfig, CollectiveSpeculation
from repro_torch.core.dependency import DependencyConfig, DependencyTracker
from repro_torch.core.glance import GlanceConfig, GlanceVerdict, NeighborhoodGlance
from repro_torch.core.rollback import ProgressLog, RollbackRegistry, plan_rollback
from repro_torch.core.speculator import (
    BinoConfig,
    BinocularSpeculator,
    LateConfig,
    Speculator,
    YarnLateSpeculator,
)
from repro_torch.core.types import (
    Action,
    AttemptState,
    AttemptView,
    ClusterSnapshot,
    FetchFailure,
    KillAttempt,
    MarkNodeFailed,
    NodeView,
    SpeculateTask,
    TaskKind,
    TaskState,
    TaskView,
)

__all__ = [
    "Action", "ArraySnapshot", "AttemptState", "AttemptView", "BinoConfig",
    "BinocularSpeculator", "ClusterSnapshot", "CollectiveConfig",
    "CollectiveSpeculation", "DependencyConfig", "DependencyTracker",
    "FetchFailure", "GlanceConfig", "GlanceVerdict", "KillAttempt",
    "LateConfig", "MarkNodeFailed", "NeighborhoodGlance", "NodeView",
    "ProgressLog", "RollbackRegistry", "Speculator", "SpeculateTask",
    "TaskKind", "TaskState", "TaskView", "YarnLateSpeculator",
    "plan_rollback",
]
