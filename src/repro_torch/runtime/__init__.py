"""Live training runtime: binocular speculation driving a torch train loop
over thread-simulated multi-host workers (real control plane — heartbeats,
progress logs, speculative reassignment, rollback — with the model math
on the process's device: the CUDA card, or the CPU in tests).
Chaos-hardened (DESIGN.md §16): fault scripts shared with the simulator,
at-least-once delivery with retry/backoff, coverage-based hole repair,
quorum rollback resume, and an injectable clock for deterministic
failure-timeline tests."""
from repro_torch.runtime.chaos import (
    PINNED_SCRIPTS,
    ChaosController,
    parse_script,
)
from repro_torch.runtime.clock import Clock, FakeClock, SystemClock
from repro_torch.runtime.coordinator import (
    Coordinator,
    RuntimeConfig,
    StepReport,
    StepWedged,
)
from repro_torch.runtime.hosts import (
    AckMessage,
    GradMessage,
    HostDaemon,
    ProgressMessage,
    WorkItem,
)
from repro_torch.runtime.trainer import TrainerRuntime

__all__ = ["AckMessage", "ChaosController", "Clock", "Coordinator",
           "FakeClock", "GradMessage", "HostDaemon", "PINNED_SCRIPTS",
           "ProgressMessage", "RuntimeConfig", "StepReport", "StepWedged",
           "SystemClock", "TrainerRuntime", "WorkItem", "parse_script"]
