"""Load the reference package's parameters and train states into the
port.

The reference keeps a model's weights as a nested dict whose per-layer
leaves are stacked on a leading ``(layers, ...)`` axis (a hybrid model's
on ``(blocks, ...)``, then on the block's layers); the port keeps one
sub-tree per layer or block
(:class:`~repro_torch.models.layers.ParamTree`). The caller turns every
leaf into a numpy array first (``np.asarray``), so this module needs
neither JAX nor ``ml_dtypes``: a bfloat16 leaf (numpy dtype name
``"bfloat16"``) is reinterpreted through a ``uint16`` view, bit for bit.
"""
from __future__ import annotations

from typing import Any, Mapping, Union

import numpy as np
import torch

from repro_torch.accel.torch_backend import require_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamTree, tree_from_leaves, \
    tree_leaves


def to_tensor(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy leaf as a torch tensor on ``device`` (a copy: JAX hands out
    read-only arrays); bfloat16 bit-exact."""
    x = np.array(x, order="C")
    if x.dtype.name == "bfloat16":
        t = torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(x)
    return t.to(device)


def _tree(node: Mapping[str, Any], device, index=()):
    """A nested dict of numpy leaves as tensors, each leaf indexed by
    ``index`` on its leading axes first."""
    out = {}
    for name, value in node.items():
        if isinstance(value, Mapping):
            out[name] = _tree(value, device, index)
        else:
            out[name] = to_tensor(value[index], device)
    return out


def _first_leaf(node: Mapping[str, Any]):
    value = next(iter(node.values()))
    return _first_leaf(value) if isinstance(value, Mapping) else value


def _block(tree: Mapping[str, Any], device, i: int) -> dict:
    """Hybrid block ``i`` of the reference's ``blocks`` (every leaf stacked
    on blocks; ``mamba``, ``moe`` and ``mlp`` then on the block's layers of
    that kind; ``lns`` on its layers, then on the norm pair)."""
    block = {"attn": _tree(tree["attn"], device, (i,))}
    for kind in ("mamba", "moe", "mlp"):
        n = _first_leaf(tree[kind]).shape[1] if tree.get(kind) else 0
        block[kind] = [_tree(tree[kind], device, (i, j)) for j in range(n)]
    n = _first_leaf(tree["lns"]).shape[1]
    block["lns"] = [{"ln1": _tree(tree["lns"], device, (i, j, 0)),
                     "ln2": _tree(tree["lns"], device, (i, j, 1))}
                    for j in range(n)]
    return block


def from_jax_params(cfg: ModelConfig, tree: Mapping[str, Any], *,
                    device: Union[str, torch.device] = "cuda") -> ParamTree:
    """The reference's parameter tree (numpy leaves) as the port's model
    on ``device``: the stacked ``layers`` leaves (MoE experts included,
    ``(layers, experts, ...)``) unstacked, one sub-tree per layer, or the
    hybrid ``blocks`` one sub-tree per block; the ``frontend`` projection
    as it is."""
    dev = require_device(str(device), "from_jax_params")
    params = {name: value for name, value in tree.items()
              if name not in ("layers", "blocks")}
    params = _tree(params, dev)
    if cfg.hybrid is not None:
        nb = cfg.n_layers // cfg.hybrid.block_len
        params["blocks"] = [_block(tree["blocks"], dev, i) for i in range(nb)]
    else:
        params["layers"] = [_tree(tree["layers"], dev, (i,))
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
