"""GQA flash attention: the forward kernel B6, the backward kernels B7
(dK, dV) and B8 (dQ), and their plain torch versions.

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

:func:`flash_attention_bwd` is the port of the reference's backward
(``flash_attention.py:290``). It computes ``delta = rowsum(dO · out)``
in float32 as a torch op (the reference computes it outside its kernels
too), then on CUDA tensors launches B7 and then B8 (``accel/csrc/
flash_attention_bwd.cu``), and on CPU tensors runs their plain versions,
:func:`flash_attention_dkv_plain` and :func:`flash_attention_dq_plain`:
the same loops over (query tile, KV tile) pairs with the reference
kernels' skips, masks (p = 0 where masked, by a ``where``) and float32
arithmetic. Unlike the reference, ragged last tiles are masked instead of
dropped by a floor-divided grid. The gradient does not depend on the
tiles: a skipped pair's p is all zero.
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


# ---------------------------------------------------------------------------
# Backward: B7 (dK, dV) and B8 (dQ)
# ---------------------------------------------------------------------------
def _pair_runs(q0: int, k0: int, q_offset: int, causal: bool, window: int,
               block_q: int, block_k: int) -> bool:
    """The reference's static skip of a (query tile, KV tile) pair
    (``flash_attention.py:184-189``)."""
    if causal and k0 > q0 + q_offset + block_q - 1:
        return False
    return not (window and not (k0 + block_k - 1 > q0 + q_offset - window))


def _bwd_tile(q, k, v, do, lse, delta, q0, k0, causal, window, scale,
              block_q, block_k):
    """p and dS (b, hkv, group, bq, bk) of one tile pair, float32; q, do
    (b, hkv, group, sq, d), k, v (b, hkv, sk, d), lse, delta (b, hkv,
    group, sq), all float32."""
    sq, sk = q.shape[3], k.shape[2]
    dev = q.device
    qt = q[..., q0:q0 + block_q, :]
    dot = do[..., q0:q0 + block_q, :]
    kt = k[:, :, None, k0:k0 + block_k]
    vt = v[:, :, None, k0:k0 + block_k]
    s = qt @ kt.transpose(-1, -2) * scale     # scale after the product
    p = torch.exp(s - lse[..., q0:q0 + block_q, None])
    q_pos = torch.arange(q0, min(q0 + block_q, sq), device=dev) + (sk - sq)
    k_pos = torch.arange(k0, min(k0 + block_k, sk), device=dev)
    mask = None
    if causal:
        mask = k_pos[None, :] <= q_pos[:, None]
    if window:
        w = k_pos[None, :] > (q_pos[:, None] - window)
        mask = w if mask is None else (mask & w)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    dp = dot @ vt.transpose(-1, -2)
    ds = p * (dp - delta[..., q0:q0 + block_q, None]) * scale
    return p, ds, qt, dot, kt


def _bwd_inputs(q, k, v, do, lse, delta):
    """Float32 copies in the (b, hkv, group, s, d) / (b, hkv, s, d)
    layout: query head h = hk * group + g."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    if hq % hkv:
        raise ValueError(f"n_heads {hq} is not a multiple of n_kv_heads "
                         f"{hkv}")
    group = hq // hkv

    def heads(x):   # (b, s, hq, d) -> (b, hkv, group, s, d)
        return x.float().permute(0, 2, 1, 3).reshape(b, hkv, group, sq, d)

    return (heads(q), k.float().permute(0, 2, 1, 3),
            v.float().permute(0, 2, 1, 3), heads(do),
            lse.float().reshape(b, hkv, group, sq),
            delta.float().reshape(b, hkv, group, sq))


def flash_attention_dkv_plain(
    q, k, v, do, lse, delta, *, causal: bool = True, window: int = 0,
    scale: Optional[float] = None, block_q: int = BLOCK_Q,
    block_k: int = BLOCK_K,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B7's plain version: (dk, dv), each (b, sk, hkv, d) in k's and v's
    type. For each KV tile, walks the query tiles whose band reaches it
    and sums dV += pᵀ·dO and dK += dSᵀ·q over them and over the query
    group, in float32."""
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = d ** -0.5
    qf, kf, vf, dof, lsef, deltaf = _bwd_inputs(q, k, v, do, lse, delta)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for k0 in range(0, sk, block_k):
        for q0 in range(0, sq, block_q):
            if not _pair_runs(q0, k0, sk - sq, causal, window, block_q,
                              block_k):
                continue
            p, ds, qt, dot, _kt = _bwd_tile(qf, kf, vf, dof, lsef, deltaf,
                                            q0, k0, causal, window, scale,
                                            block_q, block_k)
            dv[:, :, k0:k0 + block_k] += torch.einsum(
                "bhgqk,bhgqd->bhkd", p, dot)
            dk[:, :, k0:k0 + block_k] += torch.einsum(
                "bhgqk,bhgqd->bhkd", ds, qt)
    return (dk.permute(0, 2, 1, 3).to(k.dtype).contiguous(),
            dv.permute(0, 2, 1, 3).to(v.dtype).contiguous())


def flash_attention_dq_plain(
    q, k, v, do, lse, delta, *, causal: bool = True, window: int = 0,
    scale: Optional[float] = None, block_q: int = BLOCK_Q,
    block_k: int = BLOCK_K,
) -> torch.Tensor:
    """B8's plain version: dq (b, sq, hq, d) in q's type. For each query
    tile, sums dQ += dS·K over the KV tiles in its band, in float32."""
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = d ** -0.5
    qf, kf, vf, dof, lsef, deltaf = _bwd_inputs(q, k, v, do, lse, delta)
    dq = torch.zeros_like(qf)
    for q0 in range(0, sq, block_q):
        for k0 in range(0, sk, block_k):
            if not _pair_runs(q0, k0, sk - sq, causal, window, block_q,
                              block_k):
                continue
            _p, ds, _qt, _dot, kt = _bwd_tile(qf, kf, vf, dof, lsef, deltaf,
                                              q0, k0, causal, window, scale,
                                              block_q, block_k)
            dq[..., q0:q0 + block_q, :] += ds @ kt
    return dq.reshape(b, hq, sq, d).permute(0, 2, 1, 3).to(
        q.dtype).contiguous()


def bwd_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO · out) in float32, (b, hq, sq): the input that B7
    and B8 take beside lse."""
    return (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
    window: int = 0, scale: Optional[float] = None,
    block_q: int = BLOCK_Q, block_k: int = BLOCK_K,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the attention whose forward gave ``out`` and
    ``lse``, for the output gradient ``do``: B7 then B8 on CUDA tensors
    (tiles fixed at ``BLOCK_Q`` x ``BLOCK_K``), their plain versions on
    CPU tensors. dq is in q's type, dk and dv in k's and v's."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    args = (q, k, v, do, lse, bwd_delta(out, do))
    if on_cpu(q, k, v, out, lse, do):
        opts = dict(causal=causal, window=window, scale=scale,
                    block_q=block_q, block_k=block_k)
        dk, dv = flash_attention_dkv_plain(*args, **opts)
        return flash_attention_dq_plain(*args, **opts), dk, dv
    if (block_q, block_k) != (BLOCK_Q, BLOCK_K):
        raise ValueError(f"flash_attention_bwd: the CUDA kernels' tiles are "
                         f"{BLOCK_Q} x {BLOCK_K}, got {block_q} x {block_k}")
    dk, dv = K.launch_flash_dkv(*args, causal, window, scale)
    return K.launch_flash_dq(*args, causal, window, scale), dk, dv
