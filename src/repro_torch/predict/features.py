"""Tick-time feature extraction over ArraySnapshot columns (DESIGN.md §20).

One function, two call sites: dataset generation
(repro_torch.predict.dataset) samples these rows mid-sim to build the
training corpus, and the live ``PredictorPolicy``
(repro_torch.predict.policy) extracts the *same* rows each assessment
tick for inference. Sharing the code path is the leakage
guarantee — a feature that is not computable from the columns visible at
tick time cannot exist here, so it cannot leak into training either.

Deliberately excluded (§20 leakage rules): ``node_speed`` and
``rack_factor`` are injected oracle values — the fault scripts *set*
them, so a model reading them would be reading the ground-truth label.
The observable shadows (per-node progress rate ρ, silent seconds, flow
counts) are what a real AM could measure, and are what we feed.
"""
from __future__ import annotations

import numpy as np

# Fixed feature order; the corpus, the checkpoint metadata and the live
# policy all index by position into this tuple.
FEATURE_NAMES = (
    "progress",          # ζ (shuffle/compute split for reduces)
    "progress_rate",     # ζ / elapsed
    "elapsed",           # now - start
    "is_reduce",         # task kind
    "is_speculative",    # backup attempt flag
    "node_silent",       # now - last heartbeat of the hosting node
    "node_alive",
    "node_marked",       # already declared failed by a policy
    "node_supp_active",  # heartbeat-suppression window open (outage)
    "node_free_frac",    # free containers / total
    "node_rho",          # mean progress rate of running attempts on node
    "node_rho_rel",      # node_rho / cluster mean ρ (1.0 when undefined)
    "fetched_frac",      # shuffle deps fetched / deps
    "ready_frac",        # shuffle deps ready / deps
    "inflight_frac",     # shuffle deps in flight / deps
    "fail_cycles",       # fetch-failure cycles burned
    "node_flows",        # open fair-net flows touching the node
    "node_link_up",
    "rack_flows",        # open flows through the node's rack uplink
)
N_FEATURES = len(FEATURE_NAMES)


def candidate_rows(arr, now: float, *,
                   min_runtime: float = 10.0) -> np.ndarray:
    """Rows the model may score: running non-speculative attempts past
    the young-task guard, with no live backup sibling, on nodes not yet
    declared failed. The dataset probe and the live policy share this
    filter, so the training distribution IS the inference distribution
    (DESIGN.md §20)."""
    rows = arr.running_rows(now)
    if not len(rows):
        return rows
    torder = arr.skey[rows] >> 20
    starts, inv = arr.task_segments(torder)
    has_spec = np.bincount(inv, weights=arr.spec[rows],
                           minlength=len(starts)) > 0
    healthy = arr.node_alive & ~arr.node_marked
    ok = (~arr.spec[rows]) & (~has_spec[inv]) \
        & (now - arr.start[rows] >= min_runtime) \
        & healthy[arr.node[rows]]
    # one candidate per task: the first eligible row in canonical order
    # (inv is nondecreasing over canonical rows)
    ok_idx = np.flatnonzero(ok)
    seg = inv[ok_idx]
    lead = np.ones(len(seg), dtype=bool)
    lead[1:] = seg[1:] != seg[:-1]
    return rows[ok_idx[lead]]


def node_progress_rate(arr, now: float) -> np.ndarray:
    """Observable per-node ρ: mean ζ/elapsed over the *running* attempts
    each node hosts right now (0.0 for idle nodes). This is the honest
    shadow of the injected ``node_speed`` oracle — what a glance could
    measure from progress reports alone."""
    n_nodes = len(arr.node_ids)
    rows = arr.running_rows(now)
    rho = np.zeros(n_nodes)
    if not len(rows):
        return rho
    elapsed = np.maximum(now - arr.start[rows], 1e-9)
    rate = arr.progress_at(now, rows) / elapsed
    nodes = arr.node[rows]
    total = np.bincount(nodes, weights=rate, minlength=n_nodes)
    count = np.bincount(nodes, minlength=n_nodes)
    np.divide(total, count, out=rho, where=count > 0)
    return rho


def extract_features(arr, now: float, rows: np.ndarray) -> np.ndarray:
    """Feature matrix ``(len(rows), N_FEATURES)`` for attempt ``rows``
    of a live :class:`~repro_torch.core.arrays.ArraySnapshot` at time
    ``now``.

    Pure reads — no column is written, no memo beyond the snapshot's own
    ``running_rows`` tick memo is touched, so calling this from a
    sampling probe or an assessment tick cannot perturb the engine
    (the obs-on ≡ obs-off gate relies on that).
    """
    rows = np.asarray(rows, dtype=np.int64)
    k = len(rows)
    X = np.zeros((k, N_FEATURES))
    if not k:
        return X
    nodes = arr.node[rows]
    elapsed = np.maximum(now - arr.start[rows], 1e-9)
    prog = arr.progress_at(now, rows)
    rho = node_progress_rate(arr, now)
    hosted = np.bincount(
        arr.node[arr.running_rows(now)], minlength=len(arr.node_ids))
    mean_rho = float(rho[hosted > 0].mean()) if (hosted > 0).any() else 0.0
    rho_rel = (rho[nodes] / mean_rho) if mean_rho > 0 \
        else np.ones(k)
    deps = np.maximum(arr.deps[rows], 1)
    X[:, 0] = prog
    X[:, 1] = prog / elapsed
    X[:, 2] = elapsed
    X[:, 3] = arr.kind[rows] != 0
    X[:, 4] = arr.spec[rows]
    X[:, 5] = now - arr.node_hb[nodes]
    X[:, 6] = arr.node_alive[nodes]
    X[:, 7] = arr.node_marked[nodes]
    X[:, 8] = arr.node_supp[nodes] > now
    X[:, 9] = arr.node_free[nodes] / np.maximum(arr.node_total[nodes], 1)
    X[:, 10] = rho[nodes]
    X[:, 11] = rho_rel
    X[:, 12] = arr.fetched[rows] / deps
    X[:, 13] = arr.sh_ready[rows] / deps
    X[:, 14] = arr.sh_inflight[rows] / deps
    X[:, 15] = arr.sh_fail[rows]
    X[:, 16] = arr.node_flows[nodes]
    X[:, 17] = arr.node_link_up[nodes]
    X[:, 18] = arr.rack_flows[arr.node_rack[nodes]]
    return X
