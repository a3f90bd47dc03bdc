"""Training-corpus generation for the straggler predictor (DESIGN.md §20).

Replays the pinned fuzz fault scripts and a ``fleet_workload`` slice
through traced simulations, sampling per-attempt feature rows from
inside the live assessment ticks (``repro_torch.predict.features`` — the same
code path, snapshot and tick timing the live policy sees) and labeling
them *post hoc* from the flight-recorder join
(``repro_torch.obs.scorecard.attempt_outcomes``).
Features see only tick-time-visible columns; labels see only the
completed trace — the §20 leakage boundary runs exactly between the two
imports.

Determinism: every run seed, sample time and rng draw derives from the
corpus ``seed``; the ``.npz`` is written through a fixed-timestamp zip
writer (``np.savez`` stamps member mtimes, so two identical corpora
would differ byte-wise). Two calls with one seed produce byte-identical
files — tests/test_torch_predict.py pins this, and holds them equal to
the reference package's bytes.

The traced bino runs assess through ``assess_backend``: ``None`` (the
default) is torch on the CUDA card, so the corpus runs kernels B1–B4 and
raises without a card; CPU runs pass ``"numpy"`` or
``TorchBackend("cpu")``. Every backend gives the same bytes.
"""
from __future__ import annotations

import io
import json
import zipfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.scorecard import attempt_outcomes
from repro_torch.obs.trace import TraceRecorder
from repro_torch.predict.features import FEATURE_NAMES, candidate_rows, \
    extract_features

# (name, seed, script, net) — replayed under the bino policy, whose
# backups race the primaries: a primary reaped (END_KILLED) on a faulted
# node, or one that dies outright (END_FAILED), becomes a positive
# label. Fault victims are nodes 0-2: a single terasort packs its ~28
# attempts onto the first few of the 20 workers, so a fault injected on
# an idle node teaches nothing. Seeds are all >= 20 — the fig_predictor
# evaluation runs at seed 1, so no evaluation trajectory was trained on.
CORPUS_RUNS: Tuple = (
    ("fault_free", 27, [], None),
    ("crash_mid_map", 21, [("crash", 1, 0.08, 0.0)], None),
    ("crash_during_shuffle", 23, [("crash", 2, 0.25, 0.0)], None),
    ("slow_straggler", 21, [("slow", 1, 0.1, 0.3)], None),
    ("hang_liar", 22, [("hang", 2, 0.2, 0.4)], None),
    ("hb_outage", 24, [("hb", 2, 0.25, 0.8)], None),
    ("double_fault", 25, [("crash", 2, 0.2, 0.0), ("slow", 1, 0.3, 0.4)],
     None),
    ("rack_degrade", 23, [("degrade", 0, 0.25, 0.1), ("slow", 2, 0.3, 0.4)],
     ("topo", 4)),
)
# Appended in full corpora: a bursty multi-job fleet slice (several jobs
# → more nodes loaded, so mid-cluster victims are informative here).
FLEET_RUN = ("fleet_mix", 26,
             [("crash", 2, 0.25, 0.0), ("slow", 0, 0.3, 0.5)], "fleet")

# Rows are sampled *inside* the speculator's own assessment ticks (every
# SAMPLE_EVERY-th tick), not at synthetic probe times. Assessment and
# heartbeats share the 1 s event grid, so tick-time ``node_silent`` sits
# near a full heartbeat period for healthy nodes — a probe scheduled
# off-grid just after a heartbeat sees ~0 instead, and a model trained
# on such probes saturates on every live candidate (train/serve skew;
# DESIGN.md §20). Piggybacking on the real tick kills the skew exactly.
SAMPLE_EVERY = 3


def _write_npz(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """np.load-compatible .npz with pinned member timestamps (byte-
    deterministic, unlike np.savez which stamps wall-clock mtimes)."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        for name in sorted(arrays):
            buf = io.BytesIO()
            np.lib.format.write_array(
                buf, np.ascontiguousarray(arrays[name]), version=(1, 0))
            info = zipfile.ZipInfo(name + ".npy",
                                   date_time=(1980, 1, 1, 0, 0, 0))
            zf.writestr(info, buf.getvalue())


def _run_one(name: str, run_seed: int, script, net, *,
             sample_every: int, assess_backend=None
             ) -> Tuple[np.ndarray, np.ndarray, int]:
    """One traced sim → (features, labels, n_dropped)."""
    from repro_torch.sim import JobSpec, Simulation
    from repro_torch.sim.faults import apply_script

    rec = TraceRecorder()
    kw: Dict = {}
    if isinstance(net, tuple):
        kw.update(net=net[0], racks=net[1])
    sim = Simulation(policy="bino", seed=run_seed, obs=rec,
                     assess_backend=assess_backend, **kw)
    if net == "fleet":
        from repro_torch.sim.workload import fleet_workload
        jobs = [sim.submit(s) for s in fleet_workload(
            6, mean_interarrival=5.0, seed=run_seed)]
        first = jobs[0]
    else:
        first = sim.submit(JobSpec("j0", "terasort", 2.0))
    if script:
        apply_script(sim, first, script)

    feats: List[np.ndarray] = []
    aids: List[str] = []
    times: List[float] = []
    ticks = [0]

    # Piggyback on the live assessment tick: sample candidates from the
    # exact snapshot the policy assesses, at the exact moment it does.
    # Pure reads inside an existing event — no new engine events, no
    # perturbation of the bino run being traced.
    speculator = sim.speculator
    inner_assess = speculator.assess

    def sampling_assess(snap):
        ticks[0] += 1
        if (ticks[0] - 1) % sample_every == 0:
            arr, now = snap.arrays, snap.now
            rows = candidate_rows(arr, now)
            if len(rows):
                feats.append(extract_features(arr, now, rows))
                aids.extend(arr.attempt_ids[int(r)] for r in rows)
                times.extend([now] * len(rows))
        return inner_assess(snap)

    speculator.assess = sampling_assess
    sim.run()

    X = np.concatenate(feats) if feats else np.zeros((0, len(FEATURE_NAMES)))
    # Post-hoc, time-aware label join: a sampled row is positive iff its
    # attempt went bad (failed or straggled per attempt_outcomes) AND
    # the node fault had already fired at sample time. Samples of a
    # doomed attempt taken *before* its fault are negatives — at that
    # instant nothing was observably wrong, and a backup launched then
    # would have been wasted. Labeling them positive teaches the model
    # to fire on healthy-looking rows (every young reduce mid-shuffle).
    bad: Dict[str, float] = {
        o["attempt_id"]: (o["fault_time"]
                          if o["fault_time"] is not None else -1.0)
        for o in attempt_outcomes(rec)
        if o["attempt_id"] is not None and (o["failed"] or o["straggled"])}
    seen = {o["attempt_id"] for o in attempt_outcomes(rec)
            if o["attempt_id"] is not None}
    keep = np.array([a in seen for a in aids], dtype=bool)
    y = np.array([a in bad and t >= bad[a]
                  for a, t, k in zip(aids, times, keep) if k],
                 dtype=np.int8)
    return X[keep], y, int((~keep).sum())


def generate_corpus(path: str, *, seed: int = 0,
                    runs: Optional[Sequence] = None,
                    include_fleet: bool = True,
                    replicas: int = 3,
                    sample_every: int = SAMPLE_EVERY,
                    assess_backend=None) -> Dict:
    """Generate the corpus at ``path`` (.npz); returns a summary dict.

    Each script replays under ``replicas`` distinct sim seeds (fault
    windows land against different placements, so the positive set isn't
    one trajectory's). ``seed`` offsets every run seed, so distinct
    corpus seeds see distinct — but individually deterministic —
    trajectories. ``assess_backend`` is passed to every run's
    ``Simulation``.
    """
    if runs is None:
        base = list(CORPUS_RUNS) + ([FLEET_RUN] if include_fleet else [])
        runs = [(f"{name}.r{rep}", run_seed + 101 * rep, script, net)
                for rep in range(replicas)
                for (name, run_seed, script, net) in base]
    Xs: List[np.ndarray] = []
    ys: List[np.ndarray] = []
    run_idx: List[np.ndarray] = []
    dropped = 0
    run_names = []
    for i, (name, run_seed, script, net) in enumerate(runs):
        X, y, n_drop = _run_one(name, run_seed + 1009 * seed, script, net,
                                sample_every=sample_every,
                                assess_backend=assess_backend)
        Xs.append(X)
        ys.append(y)
        run_idx.append(np.full(len(y), i, dtype=np.int32))
        dropped += n_drop
        run_names.append(name)
    X = np.concatenate(Xs)
    y = np.concatenate(ys)
    meta = {
        "seed": seed,
        "runs": run_names,
        "sample_every": sample_every,
        "n_rows": int(len(y)),
        "n_positive": int(y.sum()),
        "n_dropped": dropped,
        "feature_names": list(FEATURE_NAMES),
    }
    _write_npz(path, {
        "X": X.astype(np.float64),
        "y": y,
        "run_idx": np.concatenate(run_idx),
        "feature_names": np.array(FEATURE_NAMES),
        "meta_json": np.array([json.dumps(meta, sort_keys=True)]),
    })
    return meta


def load_corpus(path: str) -> Dict:
    with np.load(path, allow_pickle=False) as z:
        out = {k: z[k] for k in z.files}
    out["meta"] = json.loads(str(out.pop("meta_json")[0]))
    return out


def train_eval_split(n: int, *, seed: int,
                     eval_frac: float = 0.2
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic permutation split; returns (train_idx, eval_idx)."""
    perm = np.random.default_rng(seed).permutation(n)
    n_eval = max(1, int(round(n * eval_frac))) if n > 1 else 0
    return np.sort(perm[n_eval:]), np.sort(perm[:n_eval])


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="predict_corpus.npz")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-fleet", action="store_true",
                    help="skip the multi-job fleet slice (faster)")
    ap.add_argument("--assess-backend", choices=("numpy",), default=None,
                    help="assess on numpy instead of the CUDA card")
    args = ap.parse_args(argv)
    meta = generate_corpus(args.out, seed=args.seed,
                           include_fleet=not args.no_fleet,
                           assess_backend=args.assess_backend)
    print(json.dumps(meta, indent=2, sort_keys=True))


if __name__ == "__main__":
    main()
