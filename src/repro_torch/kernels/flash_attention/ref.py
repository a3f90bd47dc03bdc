"""Plain torch oracle for (GQA) attention, a copy of the reference
package's ``kernels/flash_attention/ref.py``. Shapes::

    q: (batch, q_len, n_heads, head_dim)
    k: (batch, kv_len, n_kv_heads, head_dim)
    v: (batch, kv_len, n_kv_heads, head_dim)

``n_heads`` must be a multiple of ``n_kv_heads`` (GQA broadcast: query
head h reads KV head ``h // group``). Masking: ``causal`` lower-triangular
(offset so the last q row attends to the last kv row — supports decode
where q_len < kv_len), optional sliding ``window``, optional
``kv_valid_len`` for decode against a partially filled cache; masked
logits are ``-inf``. Logits are float32; the probabilities are cast to
v's type before the PV product, as the reference does.
"""
from __future__ import annotations

from typing import Optional

import torch


def _mask(q_len: int, kv_len: int, causal: bool, window: int,
          kv_valid_len: Optional[torch.Tensor],
          device) -> Optional[torch.Tensor]:
    rows = torch.arange(q_len, device=device)[:, None] + (kv_len - q_len)
    cols = torch.arange(kv_len, device=device)[None, :]
    m = None
    if causal:
        m = cols <= rows
    if window:
        w = cols > (rows - window)
        m = w if m is None else (m & w)
    if kv_valid_len is not None:
        valid = cols < kv_valid_len  # may broadcast (batch,1,1,kv)
        m = valid if m is None else (m & valid)
    return m


def _logits(q, k, scale):
    # f32 product of the upcast operands (exact for bf16 inputs, as the
    # reference's preferred_element_type=float32), then the scale
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: Optional[float] = None,
    kv_valid_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"n_heads {hq} is not a multiple of n_kv_heads "
                         f"{hkv}")
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5

    # broadcast kv heads across the query group
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)

    logits = _logits(q, k, scale)

    if kv_valid_len is not None and kv_valid_len.ndim == 1:
        kv_valid_len = kv_valid_len[:, None, None, None]
    m = _mask(sq, sk, causal, window, kv_valid_len, q.device)
    if m is not None:
        logits = logits.masked_fill(~m, float("-inf"))

    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def attention_reference_with_lse(q, k, v, *, causal=True, window=0,
                                 scale=None):
    """Reference that also returns the per-row logsumexp (b, h, q), to
    validate the forward kernel's saved statistics."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    logits = _logits(q, k, scale)
    m = _mask(sq, sk, causal, window, None, q.device)
    if m is not None:
        logits = logits.masked_fill(~m, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)  # (b, h, q)
    probs = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype), lse
