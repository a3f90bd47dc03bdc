"""Eq. 1–4 of the paper, as vectorized, substrate-agnostic math.

Two mirrored implementations are provided:

- numpy (``*_np``) — the coordinator / simulator hot path, where a single
  assessment tick covers every node at once;
- torch (``*_torch``) — the same math on tensors of any device and
  dtype, with the same NaN conventions and ``1e-9`` guards (the
  reference's jax mirrors, which its property tests pin to the numpy
  functions). Nothing on a path calls them, as in the reference.

Notation follows §III.A:
  ρ(t)   task progress rate  = ζ(t)/τ_t
  P(N^J) NodeProgressRate    = avg over tasks of job J on node N of ρ
  ζ(N^J) node progress score = Σ ProgressScore of *ongoing* tasks
  Δ(N^J) NodeProgressChangeRate (Eq. 2)
  Eq. 1  spatial slow-node test:   P < mean_NH(P) − σ_NH(P)
  Eq. 3  temporal slow-node test:  Δ|Ti < threshold × Δ|Ti−1
  Eq. 4  adaptive unresponsiveness estimate over the last L outages
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = [
    "node_progress_rate_np",
    "spatial_slow_mask_np",
    "spatial_slow_mask_batch_np",
    "temporal_slow_mask_np",
    "eq4_estimate_np",
    "eq4_estimate_weights",
    "node_progress_rate_torch",
    "spatial_slow_mask_torch",
    "temporal_slow_mask_torch",
    "eq4_estimate_torch",
]


# ---------------------------------------------------------------------------
# Eq. 1 — spatial neighborhood assessment
# ---------------------------------------------------------------------------
def node_progress_rate_np(progress: np.ndarray, runtime: np.ndarray,
                          node_of_task: np.ndarray, n_nodes: int
                          ) -> np.ndarray:
    """P(N^J) per node: mean ρ(t_i) over the job-J tasks on each node.

    progress/runtime/node_of_task are parallel arrays over the job's
    *running* tasks. Nodes with no tasks get NaN (excluded from Eq. 1).
    """
    rho = progress / np.maximum(runtime, 1e-9)
    sums = np.zeros(n_nodes)
    counts = np.zeros(n_nodes)
    np.add.at(sums, node_of_task, rho)
    np.add.at(counts, node_of_task, 1.0)
    with np.errstate(invalid="ignore"):
        return np.where(counts > 0, sums / np.maximum(counts, 1.0), np.nan)


def spatial_slow_mask_np(P: np.ndarray, neighborhoods: np.ndarray
                         ) -> np.ndarray:
    """Eq. 1: mark node i slow iff
    ``P[i] < mean(P[NH{i}]) − std(P[NH{i}])`` (NaN rows never fire).

    ``neighborhoods`` is (n_nodes, SIZE_NEIGHBOR) int indices of each node's
    neighborhood (including itself, per the paper's NH{N_i} collection).
    """
    Pn = P[neighborhoods]                      # (n, k)
    valid = ~np.isnan(Pn)
    cnt = valid.sum(axis=1)
    with np.errstate(invalid="ignore"):
        mean = np.nansum(Pn, axis=1) / np.maximum(cnt, 1)
        var = np.nansum((Pn - mean[:, None]) ** 2 * valid, axis=1) \
            / np.maximum(cnt, 1)
    std = np.sqrt(var)
    # Need ≥2 live neighbors for variation to be meaningful, and a live P.
    ok = (cnt >= 2) & ~np.isnan(P)
    return ok & (P < (mean - std))


def spatial_slow_mask_batch_np(P: np.ndarray, neighborhoods: np.ndarray
                               ) -> np.ndarray:
    """Eq. 1 batched over assessment groups: ``P`` is (groups, n_nodes) —
    one row per (job, phase) — and the result is (groups, n_nodes).

    Operation-for-operation identical to :func:`spatial_slow_mask_np`
    applied per row (same nansum element order, same clip constants), so
    the vectorized glance path is bit-equivalent to the per-job reference
    loop (DESIGN.md §11.3).
    """
    Pn = P[:, neighborhoods]                   # (g, n, k)
    valid = ~np.isnan(Pn)
    cnt = valid.sum(axis=2)
    with np.errstate(invalid="ignore"):
        mean = np.nansum(Pn, axis=2) / np.maximum(cnt, 1)
        var = np.nansum((Pn - mean[:, :, None]) ** 2 * valid, axis=2) \
            / np.maximum(cnt, 1)
    std = np.sqrt(var)
    ok = (cnt >= 2) & ~np.isnan(P)
    return ok & (P < (mean - std))


# ---------------------------------------------------------------------------
# Eq. 2–3 — temporal assessment
# ---------------------------------------------------------------------------
def temporal_slow_mask_np(zeta_now: np.ndarray, zeta_prev: np.ndarray,
                          dt_now: float, delta_prev: np.ndarray,
                          threshold_slowdown: float = 0.1,
                          min_prev_delta: float = 1e-9) -> np.ndarray:
    """Eq. 2–3 over all nodes at once.

    Returns (slow_mask, delta_now). ``zeta_*`` are per-node sums of ongoing
    ProgressScores (completed tasks excluded — the paper's guard against
    end-of-job decline); ``delta_prev`` is Δ|Ti−1 (NaN before two samples).
    """
    delta_now = (zeta_now - zeta_prev) / max(dt_now, 1e-9)
    with np.errstate(invalid="ignore"):
        slow = (~np.isnan(delta_prev)) \
            & (delta_prev > min_prev_delta) \
            & (delta_now < threshold_slowdown * delta_prev)
    return slow, delta_now


# ---------------------------------------------------------------------------
# Eq. 4 — adaptive failure threshold
# ---------------------------------------------------------------------------
def eq4_estimate_weights(L: int) -> np.ndarray:
    """Weights 2^{L+1-k} for k = 1..L (most recent outage first)."""
    k = np.arange(1, L + 1)
    return 2.0 ** (L + 1 - k)


def eq4_estimate_np(history: Sequence[float], L: int) -> Optional[float]:
    """P_{n+1} = Σ_{k=1..L} 2^{L+1−k}·R_{n+1−k} / Σ_{k=1..L} 2^k.

    ``history`` lists past outage durations, most recent LAST. Uses the last
    ``L`` entries (fewer ⇒ window shrinks to what exists; none ⇒ None).

    Note the paper's denominator Σ 2^k = 2^{L+1} − 2 differs from the
    numerator weight sum (Σ 2^{L+1−k} over k=1..L = 2^{L+1} − 2 as well —
    the two sums are equal, so this *is* a proper weighted mean).
    """
    if not history:
        return None
    h = list(history)[-L:]
    Leff = len(h)
    w = eq4_estimate_weights(Leff)
    # h is oldest→newest; R_{n+1-k} pairs k=1 with the newest entry.
    r = np.asarray(h[::-1], dtype=float)
    denom = float(np.sum(2.0 ** np.arange(1, Leff + 1)))
    return float(np.dot(w, r) / denom)


# ---------------------------------------------------------------------------
# Torch mirrors (torch imported lazily, as the reference imports jax)
# ---------------------------------------------------------------------------
def node_progress_rate_torch(progress, runtime, node_of_task, n_nodes: int):
    """:func:`node_progress_rate_np` on tensors: sums and counts by a
    scatter-add (``index_add_``; its order of addition on a card is not
    fixed, as the reference's ``.at[].add`` is not)."""
    import torch

    rho = progress / torch.clamp(runtime, min=1e-9)
    sums = rho.new_zeros(n_nodes).index_add_(0, node_of_task, rho)
    counts = rho.new_zeros(n_nodes).index_add_(0, node_of_task,
                                               torch.ones_like(rho))
    return torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                       float("nan"))


def spatial_slow_mask_torch(P, neighborhoods):
    """:func:`spatial_slow_mask_np` on tensors (Eq. 1)."""
    import torch

    Pn = P[neighborhoods]
    valid = ~torch.isnan(Pn)
    cnt = torch.clamp(valid.sum(dim=1), min=1)
    mean = torch.nansum(Pn, dim=1) / cnt
    var = torch.nansum(torch.where(valid, (Pn - mean[:, None]) ** 2, 0.0),
                       dim=1) / cnt
    std = torch.sqrt(var)
    ok = (valid.sum(dim=1) >= 2) & ~torch.isnan(P)
    return ok & (P < (mean - std))


def temporal_slow_mask_torch(zeta_now, zeta_prev, dt_now, delta_prev,
                             threshold_slowdown: float = 0.1,
                             min_prev_delta: float = 1e-9):
    """:func:`temporal_slow_mask_np` on tensors (Eq. 2–3): (slow_mask,
    delta_now); ``dt_now`` a number or a 0-d tensor."""
    import torch

    dt = torch.clamp(torch.as_tensor(dt_now, dtype=zeta_now.dtype,
                                     device=zeta_now.device), min=1e-9)
    delta_now = (zeta_now - zeta_prev) / dt
    slow = (~torch.isnan(delta_prev)) \
        & (delta_prev > min_prev_delta) \
        & (delta_now < threshold_slowdown * delta_prev)
    return slow, delta_now


def eq4_estimate_torch(history, L: int):
    """:func:`eq4_estimate_np` on a tensor: ``history`` (L,), most recent
    LAST, NaN-padded at the front; a 0-d tensor, NaN for no history."""
    import torch

    r = history[-L:].flip(0)      # index j is the j-th most recent sample
    v = ~torch.isnan(r)
    leff = v.sum().to(history.dtype)  # the live window (< L early on)
    j = torch.arange(L, dtype=history.dtype, device=history.device)
    # weight 2^{Leff+1-k} = 2^{Leff-j}; denominator sum_{k=1..Leff} 2^k
    w = torch.where(v, torch.pow(2.0, leff - j), 0.0)
    denom = torch.pow(2.0, leff + 1) - 2.0
    num = torch.sum(w * torch.where(v, r, 0.0))
    return torch.where(leff > 0, num / torch.clamp(denom, min=1.0),
                       float("nan"))
