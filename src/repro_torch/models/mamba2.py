"""Mamba-2 (SSD) block: projections + causal depthwise conv + chunked SSD
scan + gated RMSNorm + output projection, plus the single-token decode
recurrence — the port of the reference's ``repro/models/mamba2.py``. The
scan itself lives in :mod:`repro_torch.kernels.ssd` (kernel B10 with
``impl="kernel"``). It calls ``constrain`` where the reference does
(:mod:`repro_torch.parallel.sharding`: the identity off a mesh).

Two differences from the reference, both for serving from a cache that
is allocated once: :func:`mamba_block` writes its conv tail and final
state into a given cache slice (``out=``), and :func:`mamba_decode`
updates the cache it is given in place (the reference returns new
arrays). A prompt shorter than the conv's ``k - 1`` taps leaves zeros
(the conv's causal padding) in front of its tail, where the reference's
tail would be shorter than its cache.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd.ops import ssd, ssd_decode_step, ssd_with_state
from repro_torch.models.layers import ParamFactory
from repro_torch.parallel.sharding import constrain

Params = Any


def init_mamba(cfg: ModelConfig, f: ParamFactory) -> Dict[str, torch.Tensor]:
    assert cfg.ssm is not None
    s = cfg.ssm
    d = cfg.d_model
    din = s.d_inner(d)
    nh = s.n_heads(d)
    gs = s.n_groups * s.d_state
    conv_dim = din + 2 * gs
    return {
        "wz": f.normal((d, din), ("embed", "mamba_inner")),
        "wx": f.normal((d, din), ("embed", "mamba_inner")),
        "wB": f.normal((d, gs), ("embed", "mamba_group_state")),
        "wC": f.normal((d, gs), ("embed", "mamba_group_state")),
        "wdt": f.normal((d, nh), ("embed", "mamba_heads")),
        "dt_bias": f.zeros((nh,), ("mamba_heads",)),
        # A ∈ [-A_max, 0): init A_log ~ U(log 1, log 16) per mamba-2 defaults
        "A_log": f.const(torch.log(torch.linspace(1.0, 16.0, nh)),
                         ("mamba_heads",)),
        "D": f.ones((nh,), ("mamba_heads",)),
        "conv_w": f.normal((s.conv_kernel, conv_dim), (None, None),
                           scale=s.conv_kernel ** -0.5),
        "conv_b": f.zeros((conv_dim,), (None,)),
        "gate_norm": f.ones((din,), ("mamba_inner",)),
        "wo": f.normal((din, d), ("mamba_inner", "embed")),
    }


def _split_xbc(cfg: ModelConfig, xbc: torch.Tensor):
    s = cfg.ssm
    din = s.d_inner(cfg.d_model)
    gs = s.n_groups * s.d_state
    x = xbc[..., :din]
    B = xbc[..., din:din + gs]
    C = xbc[..., din + gs:]
    return x, B, C


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d. xbc: (b, s, c); w: (k, c); prev: (b, k-1, c)
    carry-in state (decode/chunk handoff)."""
    k = w.shape[0]
    if prev is None:
        prev = xbc.new_zeros((xbc.shape[0], k - 1, xbc.shape[2]))
    xpad = torch.cat([prev, xbc], dim=1)
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(k):  # k is 4: unrolled taps, in float32
        out = out + xpad[:, i:i + xbc.shape[1]].float() * w[i].float()
    out = out + b.float()
    return F.silu(out).to(xbc.dtype)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    """RMSNorm(y * silu(z)) — the mamba-2 gated normalization."""
    yf = y.float() * F.silu(z.float())
    ms = yf.square().mean(-1, keepdim=True)
    return (yf * torch.rsqrt(ms + eps) * scale.float()).to(y.dtype)


def _conv_tail(xbc: torch.Tensor, k1: int) -> torch.Tensor:
    """The last ``k1`` rows of the raw ``xbc`` (b, s, c), zeros in front
    of a shorter prompt."""
    tail = xbc[:, -k1:]
    if tail.shape[1] < k1:
        tail = torch.cat([tail.new_zeros((tail.shape[0], k1 - tail.shape[1],
                                          tail.shape[2])), tail], dim=1)
    return tail


def mamba_block(cfg: ModelConfig, p: Params, h: torch.Tensor, *,
                impl: str = "kernel", return_state: bool = False,
                out: Optional[Dict[str, torch.Tensor]] = None):
    """Full-sequence mamba mixer. h: (b, s, d). Returns (out, cache|None)
    where cache = {'conv': (b, k-1, c), 'state': (b, nh, hd, N)}; with
    ``return_state`` and ``out`` (such a dict, e.g. one layer's slice of
    the decode cache), the tail and the state are written into ``out``,
    which is returned as the cache."""
    s = cfg.ssm
    din = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)

    z = h @ p["wz"]
    xr = h @ p["wx"]
    Br = h @ p["wB"]
    Cr = h @ p["wC"]
    dt = F.softplus((h @ p["wdt"]).float() + p["dt_bias"].float())

    xbc = torch.cat([xr, Br, Cr], dim=-1)
    conv_tail = _conv_tail(xbc, s.conv_kernel - 1)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    x, B, C = _split_xbc(cfg, xbc)

    bsz, slen = h.shape[0], h.shape[1]
    x = constrain(x.reshape(bsz, slen, nh, s.head_dim),
                  "batch", "seq", "mamba_heads", "head_dim")
    B = B.reshape(bsz, slen, s.n_groups, s.d_state)
    C = C.reshape(bsz, slen, s.n_groups, s.d_state)
    A = -torch.exp(p["A_log"].float())

    cache = None
    if return_state:
        y, state = ssd_with_state(
            x, dt, A, B, C, p["D"], chunk=s.chunk_size, impl=impl,
            out_state=None if out is None else out["state"])
        if out is None:
            cache = {"conv": conv_tail, "state": state}
        else:
            out["conv"].copy_(conv_tail)
            cache = out
    else:
        y = ssd(x, dt, A, B, C, p["D"], chunk=s.chunk_size, impl=impl)
    y = y.reshape(bsz, slen, din)
    y = _gated_norm(y, z, p["gate_norm"], cfg.norm_eps)
    return constrain(y @ p["wo"], "batch", "seq", "embed"), cache


def mamba_decode(cfg: ModelConfig, p: Params, h: torch.Tensor,
                 cache: Dict[str, torch.Tensor]):
    """Single-token step. h: (b, 1, d); cache from ``mamba_block``/init,
    updated in place. Returns (out (b, 1, d), cache)."""
    s = cfg.ssm
    din = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    b = h.shape[0]

    z = (h @ p["wz"])[:, 0]
    xr = (h @ p["wx"])[:, 0]
    Br = (h @ p["wB"])[:, 0]
    Cr = (h @ p["wC"])[:, 0]
    dt = F.softplus((h @ p["wdt"]).float()[:, 0] + p["dt_bias"].float())

    xbc_t = torch.cat([xr, Br, Cr], dim=-1)               # (b, c)
    window = torch.cat([cache["conv"], xbc_t[:, None]], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window.float(),
                            p["conv_w"].float())
    conv_out = F.silu(conv_out + p["conv_b"].float())
    x, B, C = _split_xbc(cfg, conv_out.to(h.dtype))

    x = x.reshape(b, nh, s.head_dim)
    B = B.reshape(b, s.n_groups, s.d_state)
    C = C.reshape(b, s.n_groups, s.d_state)
    A = -torch.exp(p["A_log"].float())

    new_state, y = ssd_decode_step(cache["state"], x, dt, A, B, C, p["D"])
    y = y.reshape(b, din)
    y = _gated_norm(y, z, p["gate_norm"], cfg.norm_eps)
    out = (y @ p["wo"])[:, None]
    cache["conv"].copy_(window[:, 1:])
    cache["state"].copy_(new_state)
    return out, cache


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype, *,
                     device="cuda") -> Dict[str, torch.Tensor]:
    s = cfg.ssm
    din = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    conv_dim = din + 2 * s.n_groups * s.d_state
    return {
        "conv": torch.zeros((batch, s.conv_kernel - 1, conv_dim),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, nh, s.head_dim, s.d_state),
                             dtype=torch.float32, device=device),
    }
