"""Shared layer primitives: norms, RoPE, GQA attention, MLP.

Parameters live in :class:`ParamTree` modules that keep the reference
package's nested-dict layout and names (``p["wq"]`` is (d, hq, hd),
``p["wo"]`` (hq, hd, d), ...), so converting a reference tree is a copy.
Every ``init_*`` draws through a :class:`ParamFactory` and names each
leaf's logical axes at the draw, as the reference's do; the factory
decides what a leaf is: a seeded tensor (:class:`ParamFactory`), a
``meta`` tensor (:class:`MetaFactory`) or the axes themselves
(:class:`AxesFactory`), so one init walk gives the weights, their shapes
and their axes trees. The blocks call
:func:`~repro_torch.parallel.sharding.constrain` where the reference
does: the identity off a mesh and on plain tensors.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.distributed import \
    dist_decode_update_attend
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.parallel.sharding import constrain, is_dtensor

Params = Mapping[str, Any]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class ParamTree(nn.Module):
    """A nested dict of weights as an ``nn.Module``: a tensor becomes a
    parameter (frozen unless ``trainable``: serving needs no gradient), a
    dict a sub-tree, a list an ``nn.ModuleList`` of sub-trees.
    ``tree["name"]`` reads an entry, as the reference reads its dicts.
    The parameters share the given tensors' storage."""

    def __init__(self, tree: Mapping[str, Any], *, trainable: bool = False):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, torch.Tensor):
                self.register_parameter(
                    name, nn.Parameter(value.detach(),
                                       requires_grad=trainable))
            elif isinstance(value, (list, tuple)):
                self.add_module(name, nn.ModuleList(
                    ParamTree(v, trainable=trainable) for v in value))
            else:
                self.add_module(name, ParamTree(value, trainable=trainable))

    def __getitem__(self, name: str):
        return getattr(self, name)


_NODES = (ParamTree, nn.ModuleList, dict, list)


def _children(node) -> Iterator[Tuple[str, Any]]:
    if isinstance(node, (ParamTree, dict)):
        names = (sorted((*node._parameters, *node._modules))
                 if isinstance(node, ParamTree) else sorted(node))
        for name in names:
            yield name, node[name]
    else:   # nn.ModuleList or a list: index order
        for i, child in enumerate(node):
            yield str(i), child


def tree_leaves(tree) -> Dict[str, Any]:
    """Every tensor of a :class:`ParamTree` (or every leaf of a tree of
    dicts and lists: ``param_shapes``'s, ``param_axes``'s) by
    ``/``-joined path, in the reference's flattening order: names
    sorted, list entries by index (``layers/0/ffn/w_up``, ...,
    ``layers/10/...``)."""
    out: Dict[str, Any] = {}

    def walk(node, prefix):
        if not isinstance(node, _NODES):
            out[prefix] = node
            return
        for name, child in _children(node):
            walk(child, f"{prefix}/{name}" if prefix else name)

    walk(tree, "")
    return out


def tree_from_leaves(like: ParamTree, leaves: Mapping[str, torch.Tensor],
                     *, trainable: bool = False) -> ParamTree:
    """A :class:`ParamTree` shaped as ``like`` whose tensors are
    ``leaves[path]`` (paths as :func:`tree_leaves` gives them)."""

    def build(node, prefix):
        if isinstance(node, torch.Tensor):
            return leaves[prefix]
        items = [(name, build(child, f"{prefix}/{name}" if prefix else name))
                 for name, child in _children(node)]
        if isinstance(node, ParamTree):
            return dict(items)
        return [value for _name, value in items]

    return ParamTree(build(like, ""), trainable=trainable)


def cast_tree(p, dtype: torch.dtype):
    """A copy of a :class:`ParamTree` (one layer or block) as dicts and
    lists, with every floating tensor cast to ``dtype``."""
    if isinstance(p, torch.Tensor):
        return p.to(dtype) if p.is_floating_point() else p
    if isinstance(p, nn.ModuleList):
        return [cast_tree(c, dtype) for c in p]
    return {n: cast_tree(p[n], dtype) for n in (*p._parameters, *p._modules)}


# ---------------------------------------------------------------------------
# Init helper: the reference's distributions on an explicit generator.
# ---------------------------------------------------------------------------
class ParamFactory:
    """Weights drawn from a ``torch.Generator`` on ``device``: normal ×
    fan-in^-½ unless a scale is given, as the reference's factory (the
    same distributions, not JAX's bits). ``axes`` names each dimension's
    logical axis (``parallel.sharding``); this factory drops them."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype,
                 device: torch.device):
        self.generator = generator
        self.dtype = dtype
        self.device = device

    def normal(self, shape, axes, scale: Optional[float] = None):
        if scale is None:
            scale = shape[0] ** -0.5  # fan-in
        w = torch.randn(shape, generator=self.generator, dtype=torch.float32,
                        device=self.device) * scale
        return w.to(self.dtype)

    def zeros(self, shape, axes):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def ones(self, shape, axes):
        return torch.ones(shape, dtype=self.dtype, device=self.device)

    def const(self, value: torch.Tensor, axes):
        return value.to(device=self.device, dtype=self.dtype)


class MetaFactory(ParamFactory):
    """Leaves as ``meta`` tensors: shapes and dtypes, no memory (the
    reference's ``AbstractFactory``)."""

    def __init__(self, dtype: torch.dtype):
        super().__init__(None, dtype, torch.device("meta"))

    def normal(self, shape, axes, scale: Optional[float] = None):
        return torch.empty(shape, dtype=self.dtype, device=self.device)

    zeros = ones = normal

    def const(self, value: torch.Tensor, axes):
        return self.normal(value.shape, axes)


class AxesFactory(ParamFactory):
    """Leaves as their logical axes: the init walk gives the axes tree."""

    def __init__(self):
        super().__init__(None, torch.float32, torch.device("meta"))

    def normal(self, shape, axes, scale: Optional[float] = None):
        if len(axes) != len(shape):
            raise ValueError(f"axes {axes} for a leaf of shape {shape}")
        return tuple(axes)

    zeros = ones = normal

    def const(self, value: torch.Tensor, axes):
        return self.normal(value.shape, axes)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def init_norm(cfg: ModelConfig, f: ParamFactory) -> Dict[str, torch.Tensor]:
    if cfg.norm == "layernorm":
        return {"scale": f.ones((cfg.d_model,), (None,)),
                "bias": f.zeros((cfg.d_model,), (None,))}
    return {"scale": f.ones((cfg.d_model,), (None,))}


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps)
        y = y * p["scale"].float()
    return y.to(x.dtype)


def rms_norm_1d(x: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (the half-split rotation, in float32)
# ---------------------------------------------------------------------------
def rope_sin_cos(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (...,) int → sin/cos of shape (..., head_dim/2) f32."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=positions.device) / half
    inv = 1.0 / (theta ** exponent)
    ang = positions.float()[..., None] * inv
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: (b, s, h, d); sin/cos: (b, s, d/2) or (s, d/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if sin.ndim == 2:
        sin = sin[None]
        cos = cos[None]
    sin = sin[:, :, None, :]
    cos = cos[:, :, None, :]
    xf1, xf2 = x1.float(), x2.float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention block
# ---------------------------------------------------------------------------
def init_attention(cfg: ModelConfig, f: ParamFactory):
    d, hq, hkv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.resolved_head_dim())
    p = {
        "wq": f.normal((d, hq, hd), ("embed", "heads", "head_dim")),
        "wk": f.normal((d, hkv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": f.normal((d, hkv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": f.normal((hq, hd, d), ("heads", "head_dim", "embed"),
                       scale=(hq * hd) ** -0.5),
    }
    if cfg.qkv_bias:
        p["bq"] = f.zeros((hq, hd), ("heads", "head_dim"))
        p["bk"] = f.zeros((hkv, hd), ("kv_heads", "head_dim"))
        p["bv"] = f.zeros((hkv, hd), ("kv_heads", "head_dim"))
    if cfg.qk_norm:
        p["q_norm"] = f.ones((hd,), (None,))
        p["k_norm"] = f.ones((hd,), (None,))
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def _project_qkv(cfg: ModelConfig, p: Params, x: torch.Tensor):
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm_1d(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm_1d(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _out_proj(attn: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("...hk,hkd->...d") as one matrix product."""
    h, k, d = wo.shape
    return attn.flatten(-2) @ wo.reshape(h * k, d)


def attention_block(
    cfg: ModelConfig,
    p: Params,
    h: torch.Tensor,
    *,
    positions: torch.Tensor,
    impl: str = "kernel",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence (train/prefill) attention. Returns (residual output,
    kv-cache contribution {'k','v'})."""
    q, k, v = _project_qkv(cfg, p, h)
    sin, cos = rope_sin_cos(positions, cfg.resolved_head_dim(),
                            cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    q = constrain(q, "batch", "seq", "heads", "head_dim")
    k = constrain(k, "batch", "seq", "kv_heads", "head_dim")
    v = constrain(v, "batch", "seq", "kv_heads", "head_dim")
    attn = flash_attention(q, k, v.contiguous(), causal=cfg.causal,
                           window=cfg.window, impl=impl)
    out = _out_proj(attn, p["wo"])
    return constrain(out, "batch", "seq", "embed"), {"k": k, "v": v}


def _write_rows(t: torch.Tensor, index, new: torch.Tensor) -> None:
    """``t[index] = new`` in place. DTensor (the dry run) has no in-place
    rule for ``index_put_`` on a sharded cache; there the write is the
    reference's functional ``.at[].set`` (DTensor lays it out) copied
    back."""
    new = new.to(t.dtype)
    if is_dtensor(t):
        t.copy_(t.index_put(index, new))
    else:
        t[index] = new


def attention_decode(
    cfg: ModelConfig,
    p: Params,
    h: torch.Tensor,                  # (b, 1, d)
    cache: Dict[str, torch.Tensor],   # k/v: (b, S, kv, hd)
    pos: torch.Tensor,                # (b,) int32 write positions
    *,
    impl: str = "kernel",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token's attention. Writes this token's K/V into ``cache`` at
    ``pos`` in place (the reference returns an updated copy) and returns
    (output (b, 1, d), cache). ``impl="dist"``: ``cache`` holds this
    rank's chunk of the sequence, on the active mesh's ``model`` axis
    (the sequence-parallel decode, :mod:`repro_torch.kernels.
    decode_attention.distributed`)."""
    b = h.shape[0]
    q, k, v = _project_qkv(cfg, p, h)
    sin, cos = rope_sin_cos(pos[:, None], cfg.resolved_head_dim(),
                            cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    if impl == "dist":
        attn, ck, cv = dist_decode_update_attend(
            q[:, 0].contiguous(), k[:, 0], v[:, 0], cache["k"], cache["v"],
            pos)
    else:
        bidx = torch.arange(b, device=h.device)
        rows = pos.long()
        for name, new in (("k", k), ("v", v)):
            _write_rows(cache[name], (bidx, rows), new[:, 0])
        ck = constrain(cache["k"], "batch", "kv_seq", "kv_heads", "head_dim")
        cv = constrain(cache["v"], "batch", "kv_seq", "kv_heads", "head_dim")
        attn = decode_attention(q[:, 0].contiguous(), ck, cv,
                                (pos + 1).to(torch.int32), impl=impl)
    return _out_proj(attn, p["wo"])[:, None], {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def init_mlp(cfg: ModelConfig, f: ParamFactory):
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.mlp_act == "swiglu":
        return {"w_gate": f.normal((d, ff), ("embed", "mlp")),
                "w_up": f.normal((d, ff), ("embed", "mlp")),
                "w_down": f.normal((ff, d), ("mlp", "embed"))}
    return {"w_in": f.normal((d, ff), ("embed", "mlp")),
            "w_out": f.normal((ff, d), ("mlp", "embed"))}


def mlp_block(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_act == "swiglu":
        y = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
        y = constrain(y, "batch", "seq", "mlp")
        out = y @ p["w_down"]
    else:
        # jax.nn.gelu's default is the tanh approximation
        y = F.gelu(x @ p["w_in"], approximate="tanh")
        y = constrain(y, "batch", "seq", "mlp")
        out = y @ p["w_out"]
    return constrain(out, "batch", "seq", "embed")
