"""Single-token decode attention: kernel B9 and its plain torch version.

:func:`decode_attention_fwd` is the port of the reference's
``decode_attention_pallas`` (``repro/kernels/decode_attention/
decode_attention.py``). On CUDA tensors it launches B9, the CUDA kernel
in ``accel/csrc/decode_attention.cu`` (one block per KV head and
sequence, the GQA query group resident, the cache walked in tiles of 64
keys up to the sequence's valid length); on CPU tensors it runs
:func:`decode_attention_plain`, the reference kernel's blockwise loop in
torch: scores of keys at or past ``valid`` are ``-inf``, online softmax
in float32, ``l == 0`` guarded.

Precondition: ``kv_valid_len >= 1``. A sequence with ``valid <= 0`` has
no key; the oracle, the reference kernel, the plain version and B9 all
give NaN for it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.accel import kernels as K
from repro_torch.accel.torch_backend import on_cpu

BLOCK_K = K.DECODE_BLOCK_K


def decode_attention_plain(q, k, v, kv_valid_len, *,
                           scale: Optional[float] = None,
                           block_k: int = BLOCK_K) -> torch.Tensor:
    """B9's plain version: (b, h, d) in q's type. Walks the KV tiles up
    to the largest valid length; for a sequence whose tail is shorter,
    the extra tiles add exactly 0 with ``corr = 1``, the same bits as
    skipping them."""
    b, hq, d = q.shape
    _, S, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"n_heads {hq} is not a multiple of n_kv_heads "
                         f"{hkv}")
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5
    dev = q.device
    valid = kv_valid_len.to(device=dev, dtype=torch.long)
    qf = q.float().reshape(b, hkv, group, d)
    kf = k.float().permute(0, 2, 1, 3)                     # (b, hkv, S, d)
    vf = v.float().permute(0, 2, 1, 3)
    m = torch.full((b, hkv, group, 1), float("-inf"), device=dev)
    l = torch.zeros((b, hkv, group, 1), device=dev)
    acc = torch.zeros((b, hkv, group, d), device=dev)
    n = min(max(int(valid.max()), 1), S) if b else 0
    for k0 in range(0, n, block_k):
        k_pos = torch.arange(k0, min(k0 + block_k, S), device=dev)
        s = qf @ kf[:, :, k0:k0 + block_k].transpose(-1, -2) * scale
        s = torch.where(k_pos < valid[:, None, None, None], s,
                        float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(-1, keepdim=True)
        acc = acc * corr + p @ vf[:, :, k0:k0 + block_k]
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    return (acc / l_safe).reshape(b, hq, d).to(q.dtype)


def decode_attention_fwd(q, k, v, kv_valid_len, *,
                         scale: Optional[float] = None,
                         block_k: int = BLOCK_K) -> torch.Tensor:
    """q: (b, h, d); k/v: (b, S, hkv, d); kv_valid_len: (b,) int32. B9 on
    CUDA tensors (tiles of ``BLOCK_K`` keys), the plain version on CPU
    tensors."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if on_cpu(q, k, v, kv_valid_len):
        return decode_attention_plain(q, k, v, kv_valid_len, scale=scale,
                                      block_k=block_k)
    if block_k != BLOCK_K:
        raise ValueError(f"decode_attention_fwd: the CUDA kernel's tile is "
                         f"{BLOCK_K} keys, got {block_k}")
    return K.launch_decode(q, k, v, kv_valid_len.to(torch.int32), scale)
