"""Public attention op: impl selection and the gradient's wiring.

``impl``:
- ``"kernel"`` — :class:`FlashAttention`, a ``torch.autograd.Function``
  (the counterpart of the reference's ``custom_vjp``, ``ops.py:26-49``):
  its forward runs :func:`flash_attention_fwd` (kernel B6 on CUDA
  tensors, its plain version on CPU tensors) and saves q, k, v, out and
  lse; its backward runs :func:`flash_attention_bwd` (B7 then B8 on CUDA
  tensors, their plain versions on CPU tensors). The default.
- ``"ref"``    — the plain torch oracle (``ref.attention_reference``),
  differentiated by autograd: the reference for every gradient test.

The reference package defaults to ``"ref"`` and selects its Pallas
kernels with ``"pallas"``/``"auto"``; the port defaults to the kernel,
because its main path on the card goes through its kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention as _fa
from repro_torch.kernels.flash_attention import ref as _ref

IMPLS = ("kernel", "ref")


class FlashAttention(torch.autograd.Function):
    """Attention through B6 forward and B7/B8 backward (plain versions on
    CPU tensors); the gradients are those of the kernels' arithmetic."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, block_q, block_k):
        out, lse = _fa.flash_attention_fwd(
            q, k, v, causal=causal, window=window, scale=scale,
            block_q=block_q, block_k=block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, scale=scale,
                        block_q=block_q, block_k=block_k)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _fa.flash_attention_bwd(q, k, v, out, lse,
                                             do.contiguous(), **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def check_impl(impl: str, allowed=IMPLS) -> str:
    if impl not in allowed:
        raise ValueError(f"impl {impl!r}: expected one of {allowed}")
    return impl


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: Optional[float] = None,
    kv_valid_len: Optional[torch.Tensor] = None,
    impl: str = "kernel",
    block_q: int = _fa.BLOCK_Q,
    block_k: int = _fa.BLOCK_K,
) -> torch.Tensor:
    """(b, sq, h, d) × (b, sk, hkv, d)² → (b, sq, h, d)."""
    impl = check_impl(impl)
    if impl == "ref" or kv_valid_len is not None:
        # the cache-masked decode path goes through the oracle (the
        # dedicated decode kernel lives in kernels/decode_attention)
        return _ref.attention_reference(
            q, k, v, causal=causal, window=window, scale=scale,
            kv_valid_len=kv_valid_len)
    return FlashAttention.apply(q, k, v, causal, window, scale, block_q,
                                block_k)
