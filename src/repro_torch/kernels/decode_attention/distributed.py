"""Distributed flash decode: sequence-parallel attention over a KV cache
sharded on its sequence axis, the port of the reference's
``repro/kernels/decode_attention/distributed.py``.

Layout problem it solves: with the KV cache sharded seq→``model``, a
plain layout would gather the whole cache on every layer. But softmax is
an online reduction: each rank of the ``model`` axis attends over its
LOCAL chunk of the sequence and emits ``(o_partial, lse_partial)``;
combining across ranks costs ``heads × (head_dim + 1)`` floats per
sequence.

Each rank runs :func:`dist_decode_update_attend` on its own chunk
``(b, S/n, hkv, d)`` of the cache (the reference's ``shard_map`` body):

  1. the token's K/V is written into the ONE chunk that owns position
     ``pos`` (a masked write of the rank's chunk, in place);
  2. kernel B9 runs over the chunk in its lse mode with the per-rank
     valid length ``clamp(pos + 1 − chunk_start, 0, chunk)``, giving the
     float32 ``(o, lse)`` (a chunk without a key gives o = 0, lse = −inf);
     B9's plain version on CPU tensors. B9 reads the GQA group's query
     heads against their KV head: the cache is never repeated across the
     query group;
  3. the ranks combine over the axis's process group in the reference's
     ``pmax``/``psum`` form: ``all_reduce(MAX)`` of lse, then one
     ``all_reduce(SUM)`` of ``[o·w, w]`` with ``w = exp(lse − m)`` (0 for
     an empty chunk).

Queries, the new K/V and ``pos`` are the same on every rank of the axis.
At one rank ``w = 1`` and the denominator is 1, so the output is B9's
(``impl="kernel"``) bit for bit.

On ``meta`` tensors (the dry run: shapes only, no data and no card) the
local attention is B9's plain version; a DTensor cache is taken apart
into its local chunks and put back (:func:`_on_mesh`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels.decode_attention import decode_attention as _dec
from repro_torch.kernels.decode_attention import ref as _ref
from repro_torch.parallel import sharding as SH

AXIS = "model"


def local_attend(q, k, v, valid, scale):
    """B9's lse mode over one chunk: (o (b, h, d) float32, lse (b, h)
    float32); o = 0 and lse = −inf where ``valid`` is 0."""
    if k.device.type == "meta":
        return _dec.decode_attention_plain(q, k, v, valid, scale=scale,
                                           lse=True)
    return _dec.decode_attention_fwd(q, k, v, valid, scale=scale, lse=True)


def _combine(o, lse, group):
    """The ranks' rows combined by log-sum-exp: two all-reduces over
    ``group``, of (b, h) and (b, h, d + 1) floats."""
    m = lse.clone()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    w = torch.exp(lse - m)
    w = torch.where(torch.isfinite(w), w, 0.0)        # empty chunk → 0
    num_den = torch.cat([o * w[..., None], w[..., None]], dim=-1)
    dist.all_reduce(num_den, op=dist.ReduceOp.SUM, group=group)
    den = torch.clamp_min(num_den[..., -1:], 1e-30)
    return num_den[..., :-1] / den


def dist_decode_update_attend(
    q: torch.Tensor,          # (b, h, d)
    new_k: torch.Tensor,      # (b, kv, d) this token's key
    new_v: torch.Tensor,      # (b, kv, d)
    cache_k: torch.Tensor,    # (b, S/n, kv, d): this rank's chunk
    cache_v: torch.Tensor,
    pos: torch.Tensor,        # (b,) write position (== tokens so far)
    *,
    axis: str = AXIS,
    mesh=None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (attn_out (b, h, d) in q's type, cache_k, cache_v): the
    chunks are written in place and returned. ``mesh`` (default: the
    active one, :func:`~repro_torch.parallel.sharding.use_mesh`) is a
    ``DeviceMesh`` with ``axis``; this rank's chunk is chunk
    ``mesh.get_local_rank(axis)``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    mesh = _mesh(mesh, axis)
    from torch.distributed.tensor import DTensor

    if isinstance(cache_k, DTensor):
        return _on_mesh(q, new_k, new_v, cache_k, cache_v, pos, axis, mesh,
                        scale)
    return _local(q, new_k, new_v, cache_k, cache_v, pos,
                  mesh.get_local_rank(axis), mesh.get_group(axis), scale)


def dist_decode_attend(q, k, v, kv_valid_len, *, axis: str = AXIS,
                       mesh=None, scale: Optional[float] = None
                       ) -> torch.Tensor:
    """Attention of one query token per sequence over a cache sharded on
    its sequence axis, without the write: ``k``/``v`` are this rank's
    chunk (b, S/n, hkv, d), ``kv_valid_len`` (b,) the global valid
    lengths. ``decode_attention(impl="dist")``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    mesh = _mesh(mesh, axis)
    start = mesh.get_local_rank(axis) * k.shape[1]
    return _attend(q, k, v, kv_valid_len.long() - start,
                   mesh.get_group(axis), scale)


def _mesh(mesh, axis: str):
    if mesh is None:
        mesh = SH.current_mesh()
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"sequence-parallel decode: needs a mesh with a "
                         f"{axis!r} axis")
    return mesh


def _attend(q, ck, cv, local_valid, group, scale):
    """B9 over the chunk with ``clamp(local_valid, 0, chunk)`` keys, then
    the combine across the axis."""
    valid = torch.clamp(local_valid, 0, ck.shape[1]).to(torch.int32)
    o, lse = local_attend(q, ck, cv, valid, scale)
    return _combine(o, lse, group).to(q.dtype)


def _local(q, new_k, new_v, ck, cv, pos, rank: int, group, scale):
    """One rank's part: write, attend over the chunk, combine."""
    b, chunk = q.shape[0], ck.shape[1]
    start = rank * chunk
    # the masked write of the new token into this rank's chunk
    local = pos.long() - start
    in_range = (local >= 0) & (local < chunk)
    li = torch.clamp(local, 0, chunk - 1)
    bidx = torch.arange(b, device=q.device)
    keep = in_range[:, None, None]
    ck[bidx, li] = torch.where(keep, new_k.to(ck.dtype), ck[bidx, li])
    cv[bidx, li] = torch.where(keep, new_v.to(cv.dtype), cv[bidx, li])
    return _attend(q, ck, cv, local + 1, group, scale), ck, cv


def _on_mesh(q, new_k, new_v, ck, cv, pos, axis, mesh, scale):
    """DTensor inputs (the dry run): the cache laid out (batch axes, axis,
    -, -), the rest (batch axes, -, ...), as the reference's ``shard_map``
    specs; each rank's part on its local tensors; the outputs put back as
    DTensors of the same layout."""
    from torch.distributed.tensor import DTensor

    _, act_rules = SH._current_rules()
    bspec = SH.physical_spec((q.shape[0],), ("batch",), act_rules, mesh)[0]

    def local(x, spec):
        if not isinstance(x, DTensor):
            return x
        want = SH.placements(spec, mesh)
        return x.redistribute(mesh, want).to_local()

    bhd = (bspec, None, None)
    cache = (bspec, axis, None, None)
    out, ck_l, cv_l = _local(
        local(q, bhd), local(new_k, bhd), local(new_v, bhd),
        local(ck, cache), local(cv, cache), local(pos, (bspec,)),
        mesh.get_local_rank(axis), mesh.get_group(axis), scale)

    def wrap(x, spec, like):
        return DTensor.from_local(x, mesh, SH.placements(spec, mesh),
                                  run_check=False, shape=like.shape,
                                  stride=like.stride())

    return (wrap(out, bhd, q), wrap(ck_l, cache, ck), wrap(cv_l, cache, cv))


def reference(q, new_k, new_v, cache_k, cache_v, pos, *, scale=None):
    """Oracle: plain update + full decode attention (copies; the whole
    cache in one process)."""
    b = q.shape[0]
    bidx = torch.arange(b, device=q.device)
    ck, cv = cache_k.clone(), cache_v.clone()
    ck[bidx, pos.long()] = new_k.to(ck.dtype)
    cv[bidx, pos.long()] = new_v.to(cv.dtype)
    out = _ref.decode_attention_reference(q, ck, cv, pos + 1, scale=scale)
    return out, ck, cv


# ---------------------------------------------------------------------------
# Helpers: the rank's chunk of a cache, and the group.
# ---------------------------------------------------------------------------
def chunk_bounds(S: int, n: int, rank: int) -> Tuple[int, int]:
    """[start, end) of rank ``rank``'s chunk of ``S`` slots over ``n``."""
    if S % n:
        raise ValueError(f"a cache of {S} slots does not split over {n} "
                         f"ranks")
    c = S // n
    return rank * c, (rank + 1) * c


def shard_cache(cache: Dict[str, Any], n: int, rank: int
                ) -> Dict[str, Any]:
    """Rank ``rank``'s part of a decode cache (``init_cache``'s or
    ``prefill``'s layout) over ``n`` ranks: the KV leaves' slots
    ``[rank·S/n, (rank+1)·S/n)`` (their third axis) as contiguous copies,
    the Mamba leaves (which have no sequence axis) copied whole."""
    out: Dict[str, Any] = {}
    if "attn" in cache:
        S = cache["attn"]["k"].shape[2]
        lo, hi = chunk_bounds(S, n, rank)
        out["attn"] = {name: t[:, :, lo:hi].contiguous()
                       for name, t in cache["attn"].items()}
    if "mamba" in cache:
        out["mamba"] = {name: t.clone() for name, t in cache["mamba"].items()}
    return out


def group_backend(world: int, device: torch.device) -> str:
    """NCCL where each rank has a card of its own; gloo where ranks share
    one card (NCCL refuses two ranks on one GPU; the partials are only
    ``b·h·(d+1)`` floats) and on the CPU."""
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def init_decode_mesh(rank: int, world: int, init_method: str, *,
                     device: torch.device, axis: str = AXIS):
    """Join the ``world`` ranks of the decode's process group (the
    backend :func:`group_backend` picks; ``init_method`` such as
    ``tcp://localhost:<port>``) and return a one-axis ``DeviceMesh``
    named ``axis`` over them. On the card, rank ``r`` takes device ``r``
    where there is one a rank, else the given device."""
    from torch.distributed.device_mesh import DeviceMesh

    backend = group_backend(world, device)
    if backend == "nccl":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    return DeviceMesh(device.type, torch.arange(world),
                      mesh_dim_names=(axis,))
