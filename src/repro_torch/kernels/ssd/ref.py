"""Plain torch oracle for the Mamba-2 SSD (state-space dual) chunked scan,
a copy of the reference package's ``kernels/ssd/ref.py``. Shapes::

    x  : (batch, seq, n_heads, head_dim)   -- pre-gated SSM input
    dt : (batch, seq, n_heads)             -- positive step sizes (softplus'd)
    A  : (n_heads,)                        -- negative decay rates
    B  : (batch, seq, n_groups, d_state)
    C  : (batch, seq, n_groups, d_state)
    D  : (n_heads,)                        -- skip connection

Returns (y, final_state) with y: x.shape in x's type and final_state:
(batch, n_heads, head_dim, d_state) float32 — the recurrent state handed
to decode. Head h reads group ``h // (n_heads // n_groups)``.

Semantics are the discretized SSM recurrence
``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ; y_t = C_t·h_t + D x_t``,
evaluated chunk-wise: a quadratic attention-like intra-chunk term plus an
inter-chunk state recurrence (the "dual form", arXiv:2405.21060). The
reference's ``lax.scan`` over chunks is a Python loop here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _chunk_body(state, inputs, *, A, D):
    """One chunk of the SSD dual form. state: (B, H, P, N) f32."""
    x, dt, Bm, Cm = inputs  # (B,Q,H,P), (B,Q,H), (B,Q,H,N), (B,Q,H,N)
    a = dt * A[None, None, :]                      # (B,Q,H) log-decay
    a_cs = torch.cumsum(a, dim=1)                  # inclusive cumsum
    # intra-chunk ("diagonal") term: causal decay-weighted attention
    # L[s->l] = exp(a_cs[l] - a_cs[s]) for s <= l
    seg = a_cs[:, :, None, :] - a_cs[:, None, :, :]        # (B,l,s,H)
    q = torch.arange(x.shape[1], device=x.device)
    causal = (q[:, None] >= q[None, :])[None, :, :, None]
    # mask BEFORE exp: the anti-causal branch has positive seg that can
    # overflow to inf, and where(…, inf, 0) still poisons the gradient
    L = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)), 0.0)
    scores = torch.einsum("blhn,bshn->blsh", Cm, Bm) * L    # (B,l,s,H)
    xdt = x * dt[..., None]
    y_diag = torch.einsum("blsh,bshp->blhp", scores, xdt)

    # inter-chunk: contribution of the carried state
    decay_out = torch.exp(a_cs)                             # (B,Q,H)
    y_off = torch.einsum("blhn,bhpn->blhp", Cm, state) * decay_out[..., None]

    # state update for the next chunk
    total = a_cs[:, -1, :]                                  # (B,H)
    decay_in = torch.exp(total[:, None, :] - a_cs)          # (B,Q,H)
    chunk_state = torch.einsum("bshn,bshp->bhpn",
                               Bm * (dt * decay_in)[..., None], x)
    new_state = state * torch.exp(total)[:, :, None, None] + chunk_state

    y = y_diag + y_off + D[None, None, :, None] * x
    return new_state, y


def ssd_reference(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
    C: torch.Tensor, D: torch.Tensor, *, chunk: int = 64,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    assert h % g == 0
    rep = h // g
    # broadcast groups to heads
    Bh = torch.repeat_interleave(B, rep, dim=2).float()
    Ch = torch.repeat_interleave(C, rep, dim=2).float()
    xf = x.float()
    dtf = dt.float()

    chunk = min(chunk, s)
    if s % chunk:
        # zero-pad the tail: dt=0 ⇒ exp(0)=1 decay (state preserved) and a
        # zero input contribution, so padding is exactly identity.
        pad = chunk - s % chunk
        xf = torch.nn.functional.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = torch.nn.functional.pad(dtf, (0, 0, 0, pad))
        Bh = torch.nn.functional.pad(Bh, (0, 0, 0, 0, 0, pad))
        Ch = torch.nn.functional.pad(Ch, (0, 0, 0, 0, 0, pad))
    nc = xf.shape[1] // chunk

    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    Af, Df = A.float(), D.float()
    ys = []
    for c in range(nc):
        rows = slice(c * chunk, (c + 1) * chunk)
        state, y = _chunk_body(
            state, (xf[:, rows], dtf[:, rows], Bh[:, rows], Ch[:, rows]),
            A=Af, D=Df)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s].to(x.dtype)
    return y, state


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t, D):
    """Single-token recurrence. state: (B,H,P,N); x_t: (B,H,P);
    dt_t: (B,H); B_t/C_t: (B,G,N). Returns (new_state, y_t)."""
    h = x_t.shape[1]
    g = B_t.shape[1]
    rep = h // g
    Bh = torch.repeat_interleave(B_t, rep, dim=1).float()   # (B,H,N)
    Ch = torch.repeat_interleave(C_t, rep, dim=1).float()
    dtf = dt_t.float()
    xf = x_t.float()
    decay = torch.exp(dtf * A[None, :])                      # (B,H)
    new_state = (state * decay[..., None, None]
                 + torch.einsum("bhn,bhp->bhpn", Bh * dtf[..., None], xf))
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch) \
        + D[None, :, None] * xf
    return new_state, y.to(x_t.dtype)
