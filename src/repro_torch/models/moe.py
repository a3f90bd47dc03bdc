"""Top-k routed mixture-of-experts, the "dropping" formulation of the
reference's ``repro/models/moe.py``.

Each token picks its ``top_k`` experts from a softmax router; each
(token, slot) takes the next place in its expert's queue, in flattened
(token, slot) order, and is dropped past the expert's capacity (at least
128, rounded up to a multiple of 128). The kept rows are scattered into an
(experts, capacity, d_model) buffer, every expert's FFN runs over its
whole buffer as one batched product, and each token sums its slots'
outputs weighted by its renormalised gates. No Pallas kernel serves it in
the reference (its products are ``jnp.einsum``), so the port is plain
torch: ``torch.bmm`` for the expert products. It calls ``constrain``
where the reference does (:mod:`repro_torch.parallel.sharding`: the
identity off a mesh).

Three places where torch's defaults would differ from the reference:

- the router's logits are the product in the activation type, cast to
  float32 only after it;
- ``jax.lax.top_k`` breaks ties to the lower expert index; the port takes
  a stable descending sort, which keeps equal values in index order;
- the buffer is written with ``index_put_`` without accumulation: each
  kept (expert, slot) is written once, so the result is the same bits on
  every run, where a scatter-add on the card would be atomic. Dropped
  rows, which add zeros in the reference, go to a spare row that is cut
  off before the products. The slot map's inverse is written the same
  way into a plain tensor; on DTensors (the dry run), which cannot write
  a plain tensor in place through a DTensor index, it is written out of
  place (``index_put``), and off a mesh the ops are those above;
- the backward of that write and of the combine's gather would be float
  atomics on the card (``index_add_`` through ``repeat_interleave``,
  ``index_put_(accumulate=True)`` through the gather), so one
  microbatch's gradients would differ from run to run, which the
  runtime's exactly-once reduce cannot take. Both go through
  ``autograd.Function`` subclasses (:class:`Dispatch`, :class:`Combine`) whose
  forward is the same ops and whose backward is a gather over the slot
  map: each kept (expert, slot) has exactly one source (token, slot),
  so the transpose of each copy is a copy back, and a token's k slots
  are then summed in slot order.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamFactory
from repro_torch.parallel.sharding import constrain, is_dtensor

Params = Any


def init_moe(cfg: ModelConfig, f: ParamFactory) -> Dict[str, torch.Tensor]:
    assert cfg.moe is not None
    m = cfg.moe
    d, ff, e = cfg.d_model, m.d_ff_expert, m.n_experts
    up = ("expert", "embed", "expert_mlp")
    down = ("expert", "expert_mlp", "embed")
    p = {"router": f.normal((d, e), ("embed", "expert"), scale=d ** -0.5)}
    if cfg.mlp_act == "swiglu":
        p.update(w_gate=f.normal((e, d, ff), up),
                 w_up=f.normal((e, d, ff), up),
                 w_down=f.normal((e, ff, d), down, scale=ff ** -0.5))
    else:
        p.update(w_in=f.normal((e, d, ff), up),
                 w_out=f.normal((e, ff, d), down, scale=ff ** -0.5))
    return p


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for a call of ``n_tokens`` tokens: the reference's
    ``_capacity``."""
    m = cfg.moe
    cap = int(math.ceil(m.top_k * n_tokens * m.capacity_factor
                        / m.n_experts))
    return max(128, -(-cap // 128) * 128)


def route(cfg: ModelConfig, p: Params, xf: torch.Tensor):
    """The router of (t, d) tokens: (probs (t, e) float32, gate (t, k)
    float32 renormalised, eid (t, k) int64), experts in descending
    probability, ties to the lower index."""
    logits = (xf @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    gate, eid = srt[:, :k], idx[:, :k]
    return probs, gate / gate.sum(dim=-1, keepdim=True), eid


def queue(cfg: ModelConfig, eid: torch.Tensor, cap: int):
    """Each (token, slot)'s place in its expert's queue, counted in
    flattened (token, slot) order: (eflat (t·k,), pos (t·k,), keep
    (t·k,) = pos < cap). The one-hot count runs along the last axis of an
    (experts, t·k) table: a scan down 64 columns of 49,152 rows (the
    moonshot prefill) took 13 ms a layer on the card."""
    eflat = eid.reshape(-1)
    experts = torch.arange(cfg.moe.n_experts, device=eid.device)
    onehot = experts[:, None] == eflat[None, :]
    count = torch.cumsum(onehot, dim=1, dtype=torch.int64)
    pos = count.gather(0, eflat[None, :])[0] - 1
    return eflat, pos, pos < cap


def expert_ffn(cfg: ModelConfig, p: Params, buf: torch.Tensor
               ) -> torch.Tensor:
    """Every expert's FFN over its (capacity, d) rows of ``buf``."""
    if cfg.mlp_act == "swiglu":
        y = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
        y = constrain(y, "expert", "expert_cap", None)
        return torch.bmm(y, p["w_down"])
    # jax.nn.gelu's default is the tanh approximation
    y = F.gelu(torch.bmm(buf, p["w_in"]), approximate="tanh")
    y = constrain(y, "expert", "expert_cap", None)
    return torch.bmm(y, p["w_out"])


class Dispatch(torch.autograd.Function):
    """(t, d) tokens → the (rows + 1, d) buffer: token ``j // k`` into
    row ``dest[j]`` for each (token, slot) j; kept rows are distinct,
    dropped ones all go to the spare last row. The backward gathers
    each kept slot's row back (zeros for dropped slots) and sums a
    token's k slots in order."""

    @staticmethod
    def forward(ctx, xf, dest, keep, rows: int, k: int):
        buf = xf.new_zeros((rows + 1, xf.shape[1]))
        buf.index_put_((dest,), xf.repeat_interleave(k, dim=0))
        ctx.save_for_backward(dest, keep)
        ctx.k = k
        return buf

    @staticmethod
    def backward(ctx, g):
        dest, keep = ctx.saved_tensors
        rows = torch.where(keep[:, None], g[dest], 0)
        return rows.view(-1, ctx.k, g.shape[1]).sum(dim=1), None, None, \
            None, None


class Combine(torch.autograd.Function):
    """The expert outputs (rows, d) → (t·k, d): (token, slot) j reads row
    ``flat[j]`` where ``keep[j]``, zeros elsewhere. The backward writes
    each kept slot's gradient back to its row through the inverse map
    ``src`` (row → the one j that reads it; ``t·k`` for a row no slot
    reads, which picks an appended zero row): a gather, no accumulation."""

    @staticmethod
    def forward(ctx, out_rows, flat, keep, src):
        ctx.save_for_backward(src)
        return torch.where(keep[:, None], out_rows[flat], 0)

    @staticmethod
    def backward(ctx, g):
        (src,) = ctx.saved_tensors
        return torch.cat([g, g.new_zeros((1, g.shape[1]))])[src], None, \
            None, None


def moe_block(cfg: ModelConfig, p: Params, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d) → (out (b, s, d), Switch load-balance loss, a float32
    scalar)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    cap = capacity(t, cfg)
    probs, gate, eid = route(cfg, p, xf)

    # Switch-style load-balance auxiliary loss (a one-hot by comparison:
    # F.one_hot reads its input's range back to the host)
    me = probs.mean(dim=0)
    experts = torch.arange(m.n_experts, device=x.device)
    ce = (eid[..., None] == experts).float().sum(dim=1).mean(dim=0)
    aux = m.n_experts * (me * ce).sum() * m.router_aux_weight

    eflat, pos, keep = queue(cfg, eid, cap)
    # kept rows to their (expert, slot), each written once; dropped rows to
    # one spare row past the buffer, which is cut off (no host sync to
    # count the kept rows)
    rows = m.n_experts * cap
    dest = torch.where(keep, eflat * cap + pos, rows)
    buf = Dispatch.apply(xf, dest, keep, rows, m.top_k)
    buf = constrain(buf[:-1].view(m.n_experts, cap, d),
                    "expert", "expert_cap", None)
    out_buf = constrain(expert_ffn(cfg, p, buf),
                        "expert", "expert_cap", None)

    # combine: each slot's row back, weighted by its renormalised gate;
    # src is the slot map's inverse (the spare row collects the dropped
    # slots, in no fixed order, and is cut off)
    flat = torch.where(keep, dest, 0)
    src = torch.full((rows + 1,), t * m.top_k, dtype=torch.int64,
                     device=x.device)
    slots = torch.arange(t * m.top_k, device=x.device)
    if is_dtensor(dest):
        # a plain tensor cannot be written in place through a DTensor
        # index: the out-of-place form, laid out by DTensor
        src = src.index_put((dest,), slots)
    else:
        src[dest] = slots
    gathered = Combine.apply(out_buf.view(rows, d), flat, keep, src[:-1])
    gathered = gathered.reshape(t, m.top_k, d)
    out = (gathered * gate[..., None].to(x.dtype)).sum(dim=1)
    return out.reshape(b, s, d), aux
