"""Public attention op: impl selection.

``impl``:
- ``"kernel"`` — :func:`flash_attention_fwd`: kernel B6 on CUDA tensors,
  its plain torch version on CPU tensors (the default);
- ``"ref"``    — the plain torch oracle (``ref.attention_reference``).

The reference package defaults to ``"ref"`` and selects its Pallas
kernels with ``"pallas"``/``"auto"``; the port defaults to the kernel,
because its main path on the card goes through its kernels. Its gradient
waits for the backward kernels B7/B8: on CUDA, a call with an input that
requires grad raises instead of running without one (on the CPU the
plain version is differentiable torch).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention as _fa
from repro_torch.kernels.flash_attention import ref as _ref

IMPLS = ("kernel", "ref")


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
    if q.device.type != "cpu" and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention: gradients need the backward kernels B7/B8, "
            "not ported yet (ROADMAP.md Queue B); call under "
            "torch.no_grad() or pass impl='ref'")
    out, _ = _fa.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     scale=scale, block_q=block_q,
                                     block_k=block_k)
    return out
