"""Single-token decode attention: kernel B9 and its plain torch version.

:func:`decode_attention_fwd` is the port of the reference's
``decode_attention_pallas`` (``repro/kernels/decode_attention/
decode_attention.py``). On CUDA tensors it launches B9, the CUDA kernel
in ``accel/csrc/decode_attention.cu``: the cache of each (KV head,
sequence) is split into ``SPLIT`` = 128 keys, one block per split with
the GQA query group resident, each split walked in tiles of
``BLOCK_K`` = 32 keys up to the sequence's valid length and written as
float32 partials (accumulator, m, l); a second kernel adds the live
splits in split order (FlashDecoding). On CPU tensors it runs
:func:`decode_attention_plain`, which follows the same splits, tiles and
combine order in torch: scores of keys at or past ``valid`` are
``-inf``, online softmax in float32 within a split, a split with no
valid key adds nothing, ``l == 0`` guarded.

Precondition: ``kv_valid_len >= 1``. A sequence with ``valid <= 0`` has
no key; the oracle, the reference kernel, the plain version and B9 all
give NaN for it. The lse mode (``lse=True``: the sequence-parallel
decode's local attention over one rank's chunk of the cache, where a
chunk without a key is normal) returns the float32 output and each
row's log-sum-exp, and gives such a sequence o = 0 and lse = -inf.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.accel import kernels as K
from repro_torch.accel.torch_backend import on_cpu

BLOCK_K = K.DECODE_BLOCK_K
SPLIT = K.DECODE_SPLIT


def decode_attention_plain(q, k, v, kv_valid_len, *,
                           scale: Optional[float] = None,
                           block_k: int = BLOCK_K,
                           split: int = SPLIT, lse: bool = False):
    """B9's plain version: (b, h, d) in q's type. Each split of ``split``
    keys runs its own online softmax over tiles of ``block_k`` keys (all
    splits at once); tiles past a sequence's valid length add exactly 0
    with ``corr = 1``, the same bits as the kernel's skipping them. Then
    the live splits (those that start before ``min(valid, S)``) are added
    in split order: ``w_s = exp(m_s - M)``, ``L = sum w_s l_s``, ``out =
    sum w_s acc_s / L``. With ``lse`` (the kernel's lse mode): (out (b, h,
    d) float32, lse = M + log L (b, h) float32), and a sequence with no
    valid key gets o = 0 and lse = -inf instead of NaN."""
    b, hq, d = q.shape
    _, S, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"n_heads {hq} is not a multiple of n_kv_heads "
                         f"{hkv}")
    if split % block_k:
        raise ValueError(f"split {split} is not a multiple of the tile "
                         f"{block_k}")
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5
    dev = q.device
    n = torch.clamp(kv_valid_len.to(device=dev, dtype=torch.long), max=S)
    n_split = -(-S // split)
    pad = n_split * split - S
    qf = q.float().reshape(b, hkv, 1, group, d)
    # (b, hkv, splits, split, d); padded keys lie past S, so never valid
    kf, vf = (torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
              .permute(0, 2, 1, 3).reshape(b, hkv, n_split, split, d)
              for x in (k, v))
    starts = torch.arange(n_split, device=dev) * split
    ninf = float("-inf")
    m = torch.full((b, hkv, n_split, group, 1), ninf, device=dev)
    l = torch.zeros((b, hkv, n_split, group, 1), device=dev)
    acc = torch.zeros((b, hkv, n_split, group, d), device=dev)
    for t0 in range(0, split, block_k):
        pos = starts[:, None] + t0 + torch.arange(block_k, device=dev)
        s = qf @ kf[:, :, :, t0:t0 + block_k].transpose(-1, -2) * scale
        keep = pos[None] < n[:, None, None]                   # (b, sp, bk)
        s = torch.where(keep[:, None, :, None, :], s, ninf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        # a split with no valid key yet keeps m = -inf: exp of -inf - 0
        m_safe = torch.where(m_new == ninf, 0.0, m_new)
        p = torch.exp(s - m_safe)
        corr = torch.exp(m - m_safe)
        l = corr * l + p.sum(-1, keepdim=True)
        acc = acc * corr + p @ vf[:, :, :, t0:t0 + block_k]
        m = m_new
    # the combine, in split order, over the live splits only
    live = (starts[None] < n[:, None])[:, None, :, None, None]
    M = torch.where(live, m, ninf).amax(2)                  # (b, hkv, g, 1)
    L = torch.zeros_like(M)
    out = torch.zeros((b, hkv, group, d), device=dev)
    for sp in range(n_split):
        w = torch.where(live[:, :, sp], torch.exp(m[:, :, sp] - M), 0.0)
        L = L + w * l[:, :, sp]
        out = out + w * acc[:, :, sp]
    out = out / torch.where(L == 0.0, 1.0, L)
    empty = (n <= 0)[:, None, None, None]
    if lse:
        out = torch.where(empty, 0.0, out).reshape(b, hq, d)
        row_lse = torch.where(empty, ninf, M + torch.log(L))
        return out, row_lse.reshape(b, hq)
    out = torch.where(empty, float("nan"), out)
    return out.reshape(b, hq, d).to(q.dtype)


def decode_attention_fwd(q, k, v, kv_valid_len, *,
                         scale: Optional[float] = None,
                         block_k: int = BLOCK_K, lse: bool = False):
    """q: (b, h, d); k/v: (b, S, hkv, d); kv_valid_len: (b,) int32. B9 on
    CUDA tensors (splits of ``SPLIT`` keys, tiles of ``BLOCK_K``), the
    plain version on CPU tensors. ``lse``: the lse mode, (out float32,
    lse (b, h) float32), as :func:`decode_attention_plain` says."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if on_cpu(q, k, v, kv_valid_len):
        return decode_attention_plain(q, k, v, kv_valid_len, scale=scale,
                                      block_k=block_k, lse=lse)
    if block_k != BLOCK_K:
        raise ValueError(f"decode_attention_fwd: the CUDA kernel's tile is "
                         f"{BLOCK_K} keys, got {block_k}")
    return K.launch_decode(q, k, v, kv_valid_len.to(torch.int32), scale,
                           lse=lse)
