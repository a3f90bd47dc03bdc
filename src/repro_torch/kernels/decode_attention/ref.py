"""Oracle for single-token decode attention against a (partially filled)
KV cache, a copy of the reference package's
``kernels/decode_attention/ref.py``. q: (batch, n_heads, head_dim); k/v:
(batch, kv_len, n_kv_heads, head_dim); kv_valid_len: (batch,) int32.
Returns (batch, n_heads, head_dim).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ref import attention_reference


def decode_attention_reference(q, k, v, kv_valid_len, *,
                               scale: Optional[float] = None
                               ) -> torch.Tensor:
    out = attention_reference(
        q[:, None], k, v, causal=False, scale=scale,
        kv_valid_len=kv_valid_len)
    return out[:, 0]
