"""Pluggable assessment-compute backends (numpy / torch) for the
vectorized speculation policies — see DESIGN.md §13."""
from repro_torch.accel.base import (
    BACKENDS,
    TMARK,
    TPROG,
    AssessmentBackend,
    get_backend,
)

__all__ = [
    "AssessmentBackend",
    "BACKENDS",
    "TMARK",
    "TPROG",
    "get_backend",
]
