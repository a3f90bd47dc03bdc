"""``input_specs``: shape and dtype stand-ins for every model input of an
(architecture × shape) cell, the port of the reference's
``repro/models/inputs.py``. A stand-in is a tensor on the ``meta``
device: it has a shape and a dtype and holds no memory. ``materialize``
turns stand-ins into seeded tensors for reduced configurations.

Modality frontends are stubs, as in the reference: audio cells receive
precomputed frame features, VLM cells precomputed patch features and a
text stream shortened so that patches and text make ``shape.seq_len``
positions.

``input_axes`` names each input dimension's logical axis
(``parallel.sharding``), the decode cache's through the model's
``cache_axes``.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import model as MODEL

META = torch.device("meta")


def _spec(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32
    specs: Dict[str, Any] = {}
    if cfg.family == "audio":
        specs["feats"] = _spec((b, s, cfg.frontend.feature_dim), f32)
        specs["labels"] = _spec((b, s), i32)
        return specs
    if cfg.family == "vlm":
        n_p = cfg.frontend.n_prefix
        specs["feats"] = _spec((b, n_p, cfg.frontend.feature_dim), f32)
        specs["tokens"] = _spec((b, s - n_p), i32)
        specs["labels"] = _spec((b, s), i32)
        return specs
    specs["tokens"] = _spec((b, s), i32)
    specs["labels"] = _spec((b, s), i32)
    return specs


def prefill_input_specs(cfg: ModelConfig, shape: ShapeSpec
                        ) -> Dict[str, Any]:
    specs = train_input_specs(cfg, shape)
    specs.pop("labels", None)
    return specs


def decode_input_specs(cfg: ModelConfig, shape: ShapeSpec
                       ) -> Dict[str, Any]:
    """Decode takes ``serve_step``'s inputs: one new token against a cache
    of ``shape.seq_len`` positions (``init_cache`` on the meta device)."""
    b = shape.global_batch
    return {
        "cache": MODEL.init_cache(cfg, b, shape.seq_len, device=META),
        "tokens": _spec((b,), torch.int32),
        "pos": _spec((b,), torch.int32),
    }


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    if shape.kind == "train":
        return train_input_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape)
    return decode_input_specs(cfg, shape)


def input_axes(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Logical-axis tree matching ``input_specs``'s structure."""
    if shape.kind == "train" or shape.kind == "prefill":
        return {name: ("batch",) + (None,) * (leaf.ndim - 1)
                for name, leaf in input_specs(cfg, shape).items()}
    return {
        "cache": MODEL.cache_axes(cfg),
        "tokens": ("batch",),
        "pos": ("batch",),
    }


def materialize(specs, generator: torch.Generator, vocab_size: int):
    """Seeded tensors for a tree of stand-ins, on ``generator``'s device:
    integer leaves uniform in [0, max(2, vocab_size)), floating leaves
    standard normal, each leaf drawn in tree order (dicts by key order)."""
    def draw(leaf: Union[torch.Tensor, Dict[str, Any]]):
        if isinstance(leaf, dict):
            return {k: draw(v) for k, v in leaf.items()}
        dev = generator.device
        if leaf.dtype.is_floating_point:
            return torch.randn(leaf.shape, generator=generator,
                               dtype=torch.float32, device=dev
                               ).to(leaf.dtype)
        return torch.randint(0, max(2, vocab_size), leaf.shape,
                             generator=generator, dtype=leaf.dtype,
                             device=dev)

    return draw(specs)
