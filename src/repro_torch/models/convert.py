"""Load the reference package's parameters and train states into the
port.

The reference keeps a model's weights as a nested dict whose per-layer
leaves are stacked on a leading ``(layers, ...)`` axis; the port keeps one
sub-tree per layer (:class:`~repro_torch.models.layers.ParamTree`). The
caller turns every leaf into a numpy array first (``np.asarray``), so this
module needs neither JAX nor ``ml_dtypes``: a bfloat16 leaf (numpy dtype
name ``"bfloat16"``) is reinterpreted through a ``uint16`` view, bit for
bit.
"""
from __future__ import annotations

from typing import Any, Mapping, Union

import numpy as np
import torch

from repro_torch.accel.torch_backend import require_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamTree, tree_from_leaves, \
    tree_leaves
from repro_torch.models.model import check_family


def to_tensor(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy leaf as a torch tensor on ``device`` (a copy: JAX hands out
    read-only arrays); bfloat16 bit-exact."""
    x = np.array(x, order="C")
    if x.dtype.name == "bfloat16":
        t = torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(x)
    return t.to(device)


def _tree(node: Mapping[str, Any], device, layer=None):
    out = {}
    for name, value in node.items():
        if isinstance(value, Mapping):
            out[name] = _tree(value, device, layer)
        else:
            out[name] = to_tensor(value if layer is None else value[layer],
                                  device)
    return out


def from_jax_params(cfg: ModelConfig, tree: Mapping[str, Any], *,
                    device: Union[str, torch.device] = "cuda") -> ParamTree:
    """The reference's parameter tree (numpy leaves) as the port's model
    on ``device``: the stacked ``layers`` leaves unstacked, one sub-tree
    per layer."""
    check_family(cfg)
    dev = require_device(str(device), "from_jax_params")
    params = {name: value for name, value in tree.items()
              if name != "layers"}
    params = _tree(params, dev)
    params["layers"] = [_tree(tree["layers"], dev, i)
                        for i in range(cfg.n_layers)]
    return ParamTree(params)


def from_jax_train_state(cfg: ModelConfig, tree: Mapping[str, Any], *,
                         device: Union[str, torch.device] = "cuda"
                         ) -> dict:
    """The reference's train state ``{"params", "opt": {"m", "v",
    "count"}, "step"[, "ef"]}`` (numpy leaves) as the port's: trainable
    parameters, and the moments (and the compression residual) as dicts
    ``{path: tensor}`` in :func:`tree_leaves` order, each converted by
    :func:`from_jax_params`."""
    params = from_jax_params(cfg, tree["params"], device=device)
    dev = next(params.parameters()).device

    def leaves(sub):
        return tree_leaves(from_jax_params(cfg, sub, device=dev))

    state = {"params": tree_from_leaves(params, tree_leaves(params),
                                        trainable=True),
             "opt": {"m": leaves(tree["opt"]["m"]),
                     "v": leaves(tree["opt"]["v"]),
                     "count": to_tensor(tree["opt"]["count"], dev)},
             "step": to_tensor(tree["step"], dev)}
    if "ef" in tree:
        state["ef"] = leaves(tree["ef"])
    return state
