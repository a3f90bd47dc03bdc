"""repro_torch.predict — learned straggler prediction (DESIGN.md §20).

Dataset generation from traced sims (``repro_torch.predict.dataset``), a
small MLP with a torch training path and a numpy inference path
(``model``/``train``), and a ``PredictorPolicy`` speculator that runs
batched inference over the live ArraySnapshot columns each assessment
tick, beside the fixed-threshold LATE/bino/budgeted/clone policies.

Only the inference surface is imported here; dataset/train are accessed
as modules, so importing the package does not pull in the simulator.
"""
from repro_torch.predict.features import (
    FEATURE_NAMES,
    N_FEATURES,
    extract_features,
    node_progress_rate,
)
from repro_torch.predict.model import (
    checkpoint_metadata,
    default_params,
    forward_np,
    load_params_np,
    scores_np,
)
from repro_torch.predict.policy import PredictorConfig, PredictorPolicy

__all__ = [
    "FEATURE_NAMES", "N_FEATURES", "extract_features",
    "node_progress_rate",
    "default_params", "forward_np", "scores_np", "load_params_np",
    "checkpoint_metadata",
    "PredictorConfig", "PredictorPolicy",
]
