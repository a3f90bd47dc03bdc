"""The pluggable assessment-compute backend protocol (DESIGN.md §13.1).

Every per-tick dense reduction of the vectorized policies — the Eq. 1
spatial pass, the Eq. 2–3 ζ accumulation, the Eq. 4 responsiveness masks,
LATE's percentile ranking, collective winning and sibling reaping — runs
behind :class:`AssessmentBackend`. The policies keep *all* control flow
and mutable policy state (streaks, ramp rounds, outage histories) on the
host; a backend only turns columnar snapshots into small dense results.

Two implementations ship:

- ``numpy`` (:mod:`repro_torch.accel.numpy_backend`) — the columnar
  reference path, verbatim. The bit-exact host anchor.
- ``torch`` (:mod:`repro_torch.accel.torch_backend`) — padded device
  mirrors (:class:`repro_torch.core.arrays.DeviceColumns`) prepared by
  eager torch ops; the four reductions run as hand-written CUDA kernels
  (:mod:`repro_torch.accel.kernels`) on a CUDA device and as their plain
  torch versions on ``device="cpu"``. Both are bit-exact against numpy.

``get_backend(None)`` is ``torch`` on the CUDA card: without a card it
raises rather than fall back to the CPU. CPU runs name their backend:
``"numpy"`` or ``get_backend("torch", device="cpu")``.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional, Tuple, Union

import numpy as np

if TYPE_CHECKING:  # pragma: no cover — cycle guard: core imports us back
    from repro_torch.core.arrays import ArraySnapshot

# ArraySnapshot scratch columns holding the Eq. 2 per-attempt sample
# membership (sample mark + ζ at mark). Named here so every backend and
# the glance share one registry slot.
TMARK = "glance_tmark"
TPROG = "glance_tprog"

BACKENDS = ("numpy", "torch")


class AssessmentBackend:
    """One assessment tick's dense math. Stateless w.r.t. policy decisions;
    may cache per-tick extractions / device buffers internally (ticks are
    identified by ``now`` — the simulation clock is strictly increasing
    between assessments and state never changes mid-assess)."""

    name: str = "?"

    # -- Eq. 1 ----------------------------------------------------------
    def spatial_hits(self, arr: ArraySnapshot, now: float,
                     active: List[Tuple[str, int]],
                     neighborhoods: np.ndarray) -> np.ndarray:
        """(J, n_nodes) bool: Eq. 1 fired per (active job, node), both
        phases merged — pre-debounce (the streak filter stays host-side).
        """
        raise NotImplementedError

    # -- Eq. 2–3 --------------------------------------------------------
    def temporal_zeta(self, arr: ArraySnapshot, now: float,
                      active: List[Tuple[str, int]],
                      samp_flag: np.ndarray, init_flag: np.ndarray,
                      prevk: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-(job, node) ζ sums over attempts alive at both Eq. 2
        samples: ``(zeta_now, zeta_prev)``, each (J, n_nodes) float64 with
        NaN where a node hosts no surviving attempt. Also records this
        sample's per-attempt ζ into the TMARK/TPROG scratch columns for
        sampled and newly-seen jobs."""
        raise NotImplementedError

    # -- Eq. 4 ----------------------------------------------------------
    def failure_masks(self, now: float, node_hb: np.ndarray,
                      node_marked: np.ndarray, declared: np.ndarray,
                      thresholds: np.ndarray, responsive_window: float
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """(responsive, newly_failed-candidate) bool masks over nodes.
        Pure elementwise comparisons; the caller owns the lost/declared
        state transitions and outage recording."""
        raise NotImplementedError

    # -- LATE -----------------------------------------------------------
    def late_victims(self, arr: ArraySnapshot, now: float,
                     active: List[Tuple[str, int]], eligible: np.ndarray,
                     min_runtime: float, slow_task_percentile: float
                     ) -> np.ndarray:
        """(J,) int64: per active job, the columnar row of the LATE
        speculation victim, or -1 (no variation / all fast / under the
        candidate floor). Jobs with ``eligible[pos] == False`` may skip
        work; their entry is ignored by the caller."""
        raise NotImplementedError

    # -- collective -----------------------------------------------------
    def winning(self, arr: ArraySnapshot, now: float, job_idx: int,
                win_factor: float) -> bool:
        """True iff any of the job's tasks has a live speculative attempt
        outpacing its original (or running without one)."""
        raise NotImplementedError

    def reap_rows(self, arr: ArraySnapshot, now: float) -> np.ndarray:
        """Canonical-order rows of running attempts whose task completed
        with a finished sibling — the per-tick kill set."""
        raise NotImplementedError


def get_backend(spec: Union[str, AssessmentBackend, None],
                device: Optional[str] = None) -> AssessmentBackend:
    """Resolve a backend name (or pass an instance through). ``None`` and
    ``"torch"`` build the torch backend on ``device`` (default
    ``"cuda"``, which raises when no card is present)."""
    if isinstance(spec, AssessmentBackend):
        return spec
    name = (spec or "torch").lower()
    if name == "numpy":
        from repro_torch.accel.numpy_backend import NumpyBackend
        return NumpyBackend()
    if name == "torch":
        from repro_torch.accel.torch_backend import TorchBackend
        return TorchBackend(device or "cuda")
    raise ValueError(
        f"unknown assessment backend {spec!r}; expected one of {BACKENDS}")
