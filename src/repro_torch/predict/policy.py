"""PredictorPolicy: learned straggler speculation beside LATE/bino
(DESIGN.md §20).

Same Speculator protocol as yarn/bino/budgeted/clone, different verdict
source: each assessment tick runs one batched numpy forward pass of the
§20 MLP over the live candidate rows and speculates the tasks whose
score clears the calibrated threshold, under the cluster-wide
``SpeculationBudget`` admission of §19.3. Backups land through the
existing collective winning/reaping path — the model only *nominates*.

Three deliberate properties:

- **Columnar-only.** Features like shuffle status counts and per-node
  flow counters exist only in the ArraySnapshot mirror; there is no
  honest object-walk fallback, so a plain snapshot is a hard error
  (and the runtime's reference-speculator shadow is skipped for
  learned policies rather than diverged — ``learned = True`` below).
- **Numpy inference, reap on the backend.** The forward pass is numpy
  float64 (``model.forward_np``) whatever the device; the sibling reap
  runs through the assessment backend (``reap_rows``: kernel B4 on the
  card, the default, which raises without one; CPU runs pass
  ``"numpy"`` or ``TorchBackend("cpu")``). An untrained policy
  (``model.default_params``) degenerates to reap + failure detection
  with zero speculations.
- **Obs contract (§18.2).** Every emit site is ``if self.obs is not
  None``-guarded, records draw the recorder's own seq, and inference
  schedules no engine events — obs-on ≡ obs-off byte-identity holds
  under ``policy="predictor"`` (tests/test_torch_predict.py pins it).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.accel.base import AssessmentBackend, get_backend
from repro_torch.core.speculator import SpeculationBudget, Speculator
from repro_torch.core.types import (
    Action,
    ClusterSnapshot,
    KillAttempt,
    MarkNodeFailed,
    SpeculateTask,
)
from repro_torch.obs.trace import K_BUDGET, K_PREDICT
from repro_torch.predict.features import candidate_rows, extract_features
from repro_torch.predict.model import Params, default_params, scores_np


@dataclasses.dataclass(frozen=True)
class PredictorConfig:
    # Score cut for nominating a backup; overridden by the calibrated
    # value from the checkpoint metadata when a trained model is loaded.
    threshold: float = 0.7
    # Silent-heartbeat failure declaration (the Eq. 4 role, one fixed
    # window instead of the adaptive threshold — the learned model owns
    # slowness, the detector owns silence).
    fail_silent: float = 12.0
    # YARN's young-task guard, same default as LateConfig.min_runtime.
    min_runtime: float = 10.0
    # Cluster-wide speculative-slot budget as a fraction of slots.
    budget_fraction: float = 0.05
    min_budget: int = 2


class PredictorPolicy(Speculator):
    """Score-threshold speculation from a trained (or default) MLP."""

    # Runtime coordinators must not shadow a learned policy with the
    # BinocularSpeculator reference — the decisions legitimately differ
    # (DESIGN.md §20 honesty waiver).
    learned = True

    def __init__(self, node_ids: Sequence[str],
                 params: Optional[Params] = None, *,
                 cfg: PredictorConfig = PredictorConfig(),
                 total_slots: int = 160,
                 threshold: Optional[float] = None,
                 assess_backend: "Optional[str | AssessmentBackend]" = None):
        self.node_ids = list(node_ids)
        self.params = params if params is not None else default_params()
        self.cfg = cfg if threshold is None \
            else dataclasses.replace(cfg, threshold=float(threshold))
        self.backend = get_backend(assess_backend)
        self.budget = SpeculationBudget(
            max(cfg.min_budget,
                int(cfg.budget_fraction * total_slots)))
        self._declared = np.zeros(len(self.node_ids), dtype=bool)
        # Once-per-task nomination: a reaped backup must not be re-
        # launched next tick on the same model verdict — without this,
        # a post-crash congestion window churns backups (launch, lose
        # race, relaunch) and the wasted-work gate blows up.
        self._nominated: set = set()

    # Protocol compatibility: the runtime coordinator forwards progress
    # logs to its speculator; scores read the columnar mirror instead.
    def record_progress_log(self, log) -> None:
        pass

    def load_checkpoint(self, ckpt_dir: str,
                        step: Optional[int] = None) -> None:
        """Adopt a trained model and its calibrated threshold (a numpy-only
        manifest read)."""
        from repro_torch.predict.model import checkpoint_metadata, \
            load_params_np
        self.params = load_params_np(ckpt_dir, step=step)
        meta = checkpoint_metadata(ckpt_dir)
        thr = (meta or {}).get("threshold")
        if thr is not None:
            self.cfg = dataclasses.replace(self.cfg, threshold=float(thr))

    def assess(self, snap: ClusterSnapshot) -> List[Action]:
        arr = getattr(snap, "arrays", None)
        if arr is None:
            raise ValueError(
                "PredictorPolicy requires columnar snapshots "
                "(shuffle/flow features exist only in the ArraySnapshot "
                "mirror); run with columnar assessment enabled")
        now = snap.now
        actions: List[Action] = [
            KillAttempt(arr.attempt_ids[r], "sibling completed")
            for r in self.backend.reap_rows(arr, now)]

        # Failure detection: a fixed silent-window declaration. Reset on
        # heartbeat resume so a recovered outage can be re-declared.
        # Silence is the only input — node_alive is ground truth the
        # detector must not read (it is exactly what it estimates).
        silent = now - arr.node_hb
        self._declared &= ~(silent < self.cfg.fail_silent)
        cand = (silent > self.cfg.fail_silent) & ~arr.node_marked \
            & ~self._declared
        for i in np.flatnonzero(cand):
            self._declared[i] = True
            actions.append(MarkNodeFailed(self.node_ids[i],
                                          reason="predict:silent"))

        # Straggler nomination: batched inference over the shared
        # candidate filter (one primary per backup-less task, §20),
        # minus nodes this policy has declared and already-nominated
        # tasks.
        crows = candidate_rows(arr, now, min_runtime=self.cfg.min_runtime)
        if not len(crows):
            return actions
        fresh = ~self._declared[arr.node[crows]]
        fresh &= np.array([arr.task_ids[r] not in self._nominated
                           for r in crows], dtype=bool)
        crows = crows[fresh]
        if not len(crows):
            return actions
        scores = scores_np(self.params,
                           extract_features(arr, now, crows))
        hits = scores > self.cfg.threshold
        # highest score first; stable sort keeps canonical order on ties
        rank = np.argsort(-scores[hits], kind="stable")
        self.budget.begin_tick(arr.n_running_spec())
        admitted = np.zeros(int(hits.sum()), dtype=bool)
        for pos in rank:
            admitted[pos] = self.budget.admit()
            if admitted[pos]:
                tid = arr.task_ids[crows[hits][pos]]
                self._nominated.add(tid)
                actions.append(SpeculateTask(task_id=tid,
                                             reason="predict"))
        if self.obs is not None:
            hrows = crows[hits]
            for pos in range(len(hrows)):
                self.obs.emit(
                    K_PREDICT, a=int(arr.node[hrows[pos]]),
                    b=int(admitted[pos]),
                    f0=float(scores[hits][pos]),
                    f1=self.cfg.threshold,
                    obj=arr.task_ids[hrows[pos]])
            if len(hrows):
                self.obs.emit(K_BUDGET, a=self.budget.in_use,
                              b=self.budget.capacity,
                              f0=float(len(hrows)),
                              f1=float(int(admitted.sum())),
                              f2=float(int((~admitted).sum())))
        return actions

    def job_done(self, job_id: str) -> None:
        prefix = job_id + "_"
        self._nominated = {t for t in self._nominated
                           if not t.startswith(prefix)}
