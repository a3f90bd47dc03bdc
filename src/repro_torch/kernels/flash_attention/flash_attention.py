"""GQA flash attention: the forward kernel B6, the backward kernels B7
(dK, dV) and B8 (dQ), and their plain torch versions.

:func:`flash_attention_fwd` is the port of the reference's
``flash_attention_fwd`` (``repro/kernels/flash_attention/
flash_attention.py``). On CUDA tensors it launches B6 (``accel/csrc/
flash_attention.cu``), on CPU tensors it runs
:func:`flash_attention_plain`, the same blockwise online softmax written
in torch on the same tiles. B6 has two bodies, chosen by dtype and
head_dim alone (``kernels.flash_fwd_tc``):

- bf16 at head_dim 64 or 128 (every attention layer of the serving and
  training paths): the Hopper body, wgmma tensor-core products on
  TMA-fed tiles (one block per 128 query rows, query head and sequence,
  looping over KV tiles of 128 keys). It departs from the reference on
  purpose in one place: p is rounded to bf16 before ``p @ v`` (the
  tensor cores' operand type; the reference keeps p in float32), while l
  sums the float32 p, as the reference does. The plain version rounds p
  the same way for these inputs.
- float32, and bf16 at head_dim 16, 32 or 80 (hubert-xlarge's 1,280 over
  16 heads): the SIMT body, float32 FMAs on tiles of 64 x 64, with p in
  float32 throughout.

Otherwise both keep the reference kernel's arithmetic: q, k and v upcast
to float32 (exact: a bf16 product is exact in float32), the scale applied
after the product, masked scores set to -1e30 (finite, so the online
softmax stays NaN-free), tiles fully masked by the causal band or the
window skipped, and ``l == 0`` guarded. Unlike the reference, a ragged
last tile is masked instead of asserted away.

The plain version is not the oracle (``ref.attention_reference``, which
masks with ``-inf``): it exists so that the kernel is compared on the
card with the same algorithm on the same tiles. A row with no unmasked
key in its unskipped tiles gets the mean of those tiles' V here and NaN
in the oracle; inputs for comparisons avoid such rows. Those rows alone
depend on the tiles: for every other row lse is the same function at
either body's tiles, and B7/B8 read it whichever body wrote it.

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
tiles beyond summation order: a skipped pair's p is all zero. B7 and B8
have two bodies each, chosen as B6's (``kernels.flash_bwd_tc``):

- bf16 at head_dim 64 or 128: the Hopper bodies, wgmma products on
  TMA-fed tiles. They round p to bf16 before ``pᵀ·dO`` and dS before
  ``dSᵀ·q`` and ``dS·K`` (the tensor cores' operand type; the reference
  keeps both in float32), and B7 owns one query head per block: with a
  GQA group above 1 it writes float32 partials per query head, which
  ``flash_dkv_group_sum`` adds in head order
  (:func:`dkv_group_sum_plain`). The plain versions round and sum the
  same way for these inputs.
- float32, and bf16 at head_dim 16, 32 or 80 (hubert-xlarge's
  training): the SIMT bodies, float32 throughout, the group summed
  inside B7's block.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.accel import kernels as K
from repro_torch.accel.torch_backend import on_cpu

# B7's and B8's tiles (of their SIMT bodies; ``kernels.flash_bwd_tiles``
# gives each body's); the forward's depend on its body
# (``kernels.flash_fwd_tiles``).
BWD_BLOCK_Q = K.FLASH_BWD_BLOCK_Q
BWD_BLOCK_K = K.FLASH_BWD_BLOCK_K
MASKED = -1e30


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, scale: Optional[float] = None,
    block_q: Optional[int] = None, block_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B6's plain version: (out (b, sq, h, d) in q's type, lse (b, h, sq)
    float32). Walks KV tiles of ``block_k`` for all query rows at once; a
    query row's tile (of ``block_q`` rows) decides whether a KV tile is
    skipped, with the reference kernel's conditions. The tiles default to
    those of the body that takes these inputs; for the Hopper body's
    inputs p is rounded to bf16 before ``p @ v``, as that body does."""
    b, sq, hq, d = q.shape
    if block_q is None or block_k is None:
        block_q, block_k = K.flash_fwd_tiles(q.dtype, d)
    round_p = K.flash_fwd_tc(q.dtype, d)
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
        pv = p.to(torch.bfloat16).float() if round_p else p
        acc_new = acc * corr + pv @ vf[..., k0:k0 + block_k, :]
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
    block_q: Optional[int] = None, block_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (b, sq, h, d), lse (b, h, sq) float32): B6 on CUDA
    tensors (its tiles are fixed per body, ``kernels.flash_fwd_tiles``),
    the plain version on CPU tensors (on those tiles unless others are
    given)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    tiles = K.flash_fwd_tiles(q.dtype, q.shape[-1])
    if block_q is None or block_k is None:
        block_q, block_k = tiles
    if on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, block_q=block_q,
                                     block_k=block_k)
    if (block_q, block_k) != tiles:
        raise ValueError(f"flash_attention_fwd: the CUDA kernel's tiles for "
                         f"{q.dtype} at head_dim {q.shape[-1]} are "
                         f"{tiles[0]} x {tiles[1]}, got {block_q} x "
                         f"{block_k}")
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


def _to_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to bf16, as the Hopper bodies' operands."""
    return x.to(torch.bfloat16).float()


def dkv_group_sum_plain(dk_part: torch.Tensor, dv_part: torch.Tensor,
                        hkv: int, dtype: torch.dtype = torch.bfloat16
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_dkv_group_sum``'s plain version: (dk, dv), each (b, sk,
    hkv, d) in ``dtype``, from (b, sk, hq, d) float32 partials, one per
    query head; KV head hk adds the partials of heads ``hk * group + g``
    in order of g, in float32."""
    b, sk, hq, d = dk_part.shape
    group = hq // hkv

    def total(part):
        part = part.reshape(b, sk, hkv, group, d)
        acc = part[:, :, :, 0]
        for g in range(1, group):
            acc = acc + part[:, :, :, g]
        return acc.to(dtype).contiguous()

    return total(dk_part), total(dv_part)


def flash_attention_dkv_plain(
    q, k, v, do, lse, delta, *, causal: bool = True, window: int = 0,
    scale: Optional[float] = None, block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B7's plain version: (dk, dv), each (b, sk, hkv, d) in k's and v's
    type. For each KV tile, walks the query tiles whose band reaches it
    and sums dV += pᵀ·dO and dK += dSᵀ·q over them and over the query
    group, in float32. The tiles default to those of the body that takes
    these inputs; for the Hopper body's inputs p and dS are rounded to
    bf16 before the products, each query head's sum is kept apart, and
    the group's are added in head order (:func:`dkv_group_sum_plain`), as
    that body does."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if block_q is None or block_k is None:
        block_q, block_k = K.flash_bwd_tiles(q.dtype, d)
    tc = K.flash_bwd_tc(q.dtype, d)
    if scale is None:
        scale = d ** -0.5
    qf, kf, vf, dof, lsef, deltaf = _bwd_inputs(q, k, v, do, lse, delta)
    # per query head on the Hopper body: (b, hkv, group, sk, d)
    dk = qf.new_zeros((b, hkv, hq // hkv, sk, d)) if tc else \
        torch.zeros_like(kf)
    dv = torch.zeros_like(dk)
    sums = "bhgqk,bhgqd->bhgkd" if tc else "bhgqk,bhgqd->bhkd"
    for k0 in range(0, sk, block_k):
        for q0 in range(0, sq, block_q):
            if not _pair_runs(q0, k0, sk - sq, causal, window, block_q,
                              block_k):
                continue
            p, ds, qt, dot, _kt = _bwd_tile(qf, kf, vf, dof, lsef, deltaf,
                                            q0, k0, causal, window, scale,
                                            block_q, block_k)
            if tc:
                p, ds = _to_bf16(p), _to_bf16(ds)
            dv[..., k0:k0 + block_k, :] += torch.einsum(sums, p, dot)
            dk[..., k0:k0 + block_k, :] += torch.einsum(sums, ds, qt)
    if tc:   # (b, hkv, group, sk, d) -> (b, sk, hq, d) partials
        parts = [x.permute(0, 3, 1, 2, 4).reshape(b, sk, hq, d)
                 for x in (dk, dv)]
        return dkv_group_sum_plain(*parts, hkv, k.dtype)
    return (dk.permute(0, 2, 1, 3).to(k.dtype).contiguous(),
            dv.permute(0, 2, 1, 3).to(v.dtype).contiguous())


def flash_attention_dq_plain(
    q, k, v, do, lse, delta, *, causal: bool = True, window: int = 0,
    scale: Optional[float] = None, block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """B8's plain version: dq (b, sq, hq, d) in q's type. For each query
    tile, sums dQ += dS·K over the KV tiles in its band, in float32. The
    tiles default to those of the body that takes these inputs; for the
    Hopper body's inputs dS is rounded to bf16 before the product, as that
    body does."""
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    if block_q is None or block_k is None:
        block_q, block_k = K.flash_bwd_tiles(q.dtype, d)
    tc = K.flash_bwd_tc(q.dtype, d)
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
            dq[..., q0:q0 + block_q, :] += (_to_bf16(ds) if tc else ds) @ kt
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
    block_q: Optional[int] = None, block_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the attention whose forward gave ``out`` and
    ``lse``, for the output gradient ``do``: B7 then B8 on CUDA tensors
    (their tiles are fixed per body, ``kernels.flash_bwd_tiles``), their
    plain versions on CPU tensors (on those tiles unless others are
    given). dq is in q's type, dk and dv in k's and v's."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    tiles = K.flash_bwd_tiles(q.dtype, q.shape[-1])
    if block_q is None or block_k is None:
        block_q, block_k = tiles
    args = (q, k, v, do, lse, bwd_delta(out, do))
    if on_cpu(q, k, v, out, lse, do):
        opts = dict(causal=causal, window=window, scale=scale,
                    block_q=block_q, block_k=block_k)
        dk, dv = flash_attention_dkv_plain(*args, **opts)
        return flash_attention_dq_plain(*args, **opts), dk, dv
    if (block_q, block_k) != tiles:
        raise ValueError(f"flash_attention_bwd: the CUDA kernels' tiles for "
                         f"{q.dtype} at head_dim {q.shape[-1]} are "
                         f"{tiles[0]} x {tiles[1]}, got {block_q} x "
                         f"{block_k}")
    dk, dv = K.launch_flash_dkv(*args, causal, window, scale)
    return K.launch_flash_dq(*args, causal, window, scale), dk, dv
