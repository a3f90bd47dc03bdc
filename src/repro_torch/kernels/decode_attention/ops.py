"""Public decode-attention op (forward only: the serving path, no grads).

``impl``: ``"kernel"`` (the default: kernel B9 on CUDA tensors, its plain
version on CPU tensors), ``"ref"`` (the oracle) or ``"dist"`` (the
sequence-parallel decode over a cache sharded on its sequence axis:
``k``/``v`` are this rank's chunk, :mod:`.distributed`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention import decode_attention as _dec
from repro_torch.kernels.decode_attention import distributed as _dist
from repro_torch.kernels.decode_attention import ref as _ref
from repro_torch.kernels.flash_attention.ops import IMPLS, check_impl


def decode_attention(q, k, v, kv_valid_len, *, scale: Optional[float] = None,
                     impl: str = "kernel",
                     block_k: int = _dec.BLOCK_K) -> torch.Tensor:
    """q: (b, h, d) single-token queries; k/v: (b, sk, hkv, d) cache (with
    ``impl="dist"`` this rank's chunk of it, on the active mesh)."""
    if check_impl(impl, IMPLS + ("dist",)) == "dist":
        return _dist.dist_decode_attend(q, k, v, kv_valid_len, scale=scale)
    if impl == "ref":
        return _ref.decode_attention_reference(q, k, v, kv_valid_len,
                                               scale=scale)
    return _dec.decode_attention_fwd(q, k, v, kv_valid_len, scale=scale,
                                     block_k=block_k)
