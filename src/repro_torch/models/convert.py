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


def _tree(node: Mapping[str, Any], leaf, index=()):
    """A nested dict of the reference's leaves as the port's: each leaf
    ``leaf(value, index)``, ``index`` the position on the leaf's leading
    (stacked) axes."""
    out = {}
    for name, value in node.items():
        if isinstance(value, Mapping):
            out[name] = _tree(value, leaf, index)
        else:
            out[name] = leaf(value, index)
    return out


def _block(cfg: ModelConfig, tree: Mapping[str, Any], leaf, i: int) -> dict:
    """Hybrid block ``i`` of the reference's ``blocks`` (every leaf stacked
    on blocks; ``mamba``, ``moe`` and ``mlp`` then on the block's layers of
    that kind; ``lns`` on its layers, then on the norm pair)."""
    hb = cfg.hybrid
    n_moe = sum(1 for j in range(hb.block_len)
                if cfg.moe is not None and cfg.moe.is_moe_layer(j))
    counts = {"mamba": hb.block_len - 1, "moe": n_moe,
              "mlp": hb.block_len - n_moe}
    block = {"attn": _tree(tree["attn"], leaf, (i,))}
    for kind, n in counts.items():
        block[kind] = [_tree(tree[kind], leaf, (i, j)) for j in range(n)]
    block["lns"] = [{"ln1": _tree(tree["lns"], leaf, (i, j, 0)),
                     "ln2": _tree(tree["lns"], leaf, (i, j, 1))}
                    for j in range(hb.block_len)]
    return block


def _convert(cfg: ModelConfig, tree: Mapping[str, Any], leaf) -> dict:
    """The reference's weights-shaped tree in the port's layout (nested
    dicts and lists), each leaf ``leaf(value, index)``."""
    out = _tree({name: value for name, value in tree.items()
                 if name not in ("layers", "blocks")}, leaf)
    if cfg.hybrid is not None:
        nb = cfg.n_layers // cfg.hybrid.block_len
        out["blocks"] = [_block(cfg, tree["blocks"], leaf, i)
                         for i in range(nb)]
    else:
        out["layers"] = [_tree(tree["layers"], leaf, (i,))
                         for i in range(cfg.n_layers)]
    return out


def from_jax_params(cfg: ModelConfig, tree: Mapping[str, Any], *,
                    device: Union[str, torch.device] = "cuda") -> ParamTree:
    """The reference's parameter tree (numpy leaves) as the port's model
    on ``device``: the stacked ``layers`` leaves (MoE experts included,
    ``(layers, experts, ...)``) unstacked, one sub-tree per layer, or the
    hybrid ``blocks`` one sub-tree per block; the ``frontend`` projection
    as it is."""
    dev = require_device(str(device), "from_jax_params")
    return ParamTree(_convert(
        cfg, tree, lambda value, index: to_tensor(value[index], dev)))


def from_jax_axes(cfg: ModelConfig, axes: Mapping[str, Any]) -> dict:
    """The reference's ``param_axes`` tree in the port's layout
    (``param_axes``'s): each leaf without the stacked axes' leading names
    (``"layers"``; the hybrid's ``"layers"``, ``"layers"``, and for its
    norms ``"norm_pair"``), which the port's lists stand for."""
    return _convert(cfg, axes, lambda value, index: tuple(value[len(index):]))


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
