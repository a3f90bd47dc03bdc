"""GQA flash-attention forward: kernel B6 and its plain torch version.

:func:`flash_attention_fwd` is the port of the reference's
``flash_attention_fwd`` (``repro/kernels/flash_attention/
flash_attention.py``). On CUDA tensors it launches B6, the CUDA kernel in
``accel/csrc/flash_attention.cu`` (one block per query tile of 64 rows,
query head and sequence, looping over KV tiles of 64 keys); on CPU
tensors it runs :func:`flash_attention_plain`, the same blockwise online
softmax written in torch. Both keep the reference kernel's arithmetic:
q, k and v upcast to float32, the scale applied after the product,
masked scores set to -1e30 (finite, so the online softmax stays NaN-free),
tiles fully masked by the causal band or the window skipped, and
``l == 0`` guarded. Unlike the reference, a ragged last tile is masked
instead of asserted away.

The plain version is not the oracle (``ref.attention_reference``, which
masks with ``-inf``): it exists so that the kernel is compared on the
card with the same algorithm on the same tiles. A row with no unmasked
key in its unskipped tiles gets the mean of those tiles' V here and NaN
in the oracle; inputs for comparisons avoid such rows.

The backward kernels (B7, B8) are not ported yet: :func:`flash_attention_bwd`
raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.accel import kernels as K
from repro_torch.accel.torch_backend import on_cpu

BLOCK_Q = K.FLASH_BLOCK_Q
BLOCK_K = K.FLASH_BLOCK_K
MASKED = -1e30


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, scale: Optional[float] = None,
    block_q: int = BLOCK_Q, block_k: int = BLOCK_K,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B6's plain version: (out (b, sq, h, d) in q's type, lse (b, h, sq)
    float32). Walks KV tiles of ``block_k`` for all query rows at once; a
    query row's tile (of ``block_q`` rows) decides whether a KV tile is
    skipped, with the reference kernel's conditions."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"n_heads {hq} is not a multiple of n_kv_heads "
                         f"{hkv}")
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5
    dev = q.device
    q_offset = sk - sq
    # (b, s, h, d) -> (b, hkv, group, s, d): query head h = hk * group + g
    qf = q.float().permute(0, 2, 1, 3).reshape(b, hkv, group, sq, d)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]        # (b, hkv, 1, sk, d)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    q_pos = torch.arange(sq, device=dev) + q_offset        # (sq,)
    tile_q0 = torch.div(torch.arange(sq, device=dev), block_q,
                        rounding_mode="floor") * block_q + q_offset

    m = torch.full((b, hkv, group, sq, 1), float("-inf"), device=dev)
    l = torch.zeros((b, hkv, group, sq, 1), device=dev)
    acc = torch.zeros((b, hkv, group, sq, d), device=dev)
    for k0 in range(0, sk, block_k):
        run = torch.ones(sq, dtype=torch.bool, device=dev)
        if causal:
            run &= k0 <= tile_q0 + block_q - 1
        if window:
            run &= (k0 + block_k - 1) > tile_q0 - window
        if not bool(run.any()):
            continue
        k_pos = torch.arange(k0, min(k0 + block_k, sk), device=dev)
        s = qf @ kf[..., k0:k0 + block_k, :].transpose(-1, -2) * scale
        mask = None
        if causal:
            mask = k_pos[None, :] <= q_pos[:, None]
        if window:
            w = k_pos[None, :] > (q_pos[:, None] - window)
            mask = w if mask is None else (mask & w)
        if mask is not None:
            s = torch.where(mask, s, MASKED)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l_new = corr * l + p.sum(-1, keepdim=True)
        acc_new = acc * corr + p @ vf[..., k0:k0 + block_k, :]
        keep = run[:, None]
        m = torch.where(keep, m_new, m)
        l = torch.where(keep, l_new, l)
        acc = torch.where(keep, acc_new, acc)
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = (acc / l_safe).reshape(b, hq, sq, d).permute(0, 2, 1, 3)
    lse = (m + torch.log(l_safe)).reshape(b, hq, sq)
    return out.to(q.dtype).contiguous(), lse


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, scale: Optional[float] = None,
    block_q: int = BLOCK_Q, block_k: int = BLOCK_K,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (b, sq, h, d), lse (b, h, sq) float32): B6 on CUDA
    tensors (its tiles are fixed at ``BLOCK_Q`` x ``BLOCK_K``), the plain
    version on CPU tensors."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, block_q=block_q,
                                     block_k=block_k)
    if (block_q, block_k) != (BLOCK_Q, BLOCK_K):
        raise ValueError(f"flash_attention_fwd: the CUDA kernel's tiles are "
                         f"{BLOCK_Q} x {BLOCK_K}, got {block_q} x {block_k}")
    return K.launch_flash_fwd(q, k, v, causal, window, scale)


def flash_attention_bwd(q, k, v, out, lse, do, *, causal=True, window=0,
                        scale=None, block_q=BLOCK_Q, block_k=BLOCK_K):
    """The backward kernels B7 (dK, dV) and B8 (dQ) are not ported yet."""
    raise NotImplementedError(
        "flash_attention_bwd: kernels B7/B8 (training) are not ported yet; "
        "see ROADMAP.md Queue B")
