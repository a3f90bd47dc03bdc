"""Mamba-2 SSD chunked scan: kernel B10 and its plain torch version.

:func:`ssd_fwd` is the port of the reference's ``ssd_pallas``
(``repro/kernels/ssd/ssd.py``). On CUDA tensors it launches B10, the CUDA
kernel in ``accel/csrc/ssd.cu`` (one block per (batch, head) walking the
chunks in order, the (head_dim × d_state) state in shared memory across
chunks); on CPU tensors it runs :func:`ssd_plain`, which walks the same
chunks for all (batch, head) at once with the kernel's arithmetic.

Unlike the Pallas kernel, which asserts ``s % chunk == 0``, both take a
ragged tail with the oracle's semantics: the last chunk is shorter, and
rows past ``s`` (the oracle's zero padding, dt = 0) weigh nothing and
write nothing. ``chunk = min(chunk, s)``, as in the reference.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.accel import kernels as K
from repro_torch.accel.torch_backend import on_cpu


def ssd_plain(x, dt, A, B, C, D, *, chunk: int = 128,
              out_state: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B10's plain version: (y in x's type, final state (b, h, p, n)
    float32). Per chunk, as the kernel computes it: the inclusive cumsum
    of dt·A, the carried-state term C·stateᵀ·exp(a_cs), the causal pairs'
    (C·Bᵀ)·exp(a_cs[l] − a_cs[s])·dt_s (exp only where s ≤ l) against x,
    D·x, then state ← state·exp(total) + (B·dt·exp(total − a_cs))ᵀ·x."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if h % g:
        raise ValueError(f"ssd: {h} heads do not split into {g} groups")
    dev = x.device
    head_group = torch.arange(h, device=dev) // (h // g)
    chunk = min(chunk, s)
    Af, Df = A.float(), D.float()
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    for c0 in range(0, s, chunk):
        rows = slice(c0, min(c0 + chunk, s))
        xs = x[:, rows].float()                              # (b, q, h, p)
        dts = dt[:, rows].float()                            # (b, q, h)
        Bs = B[:, rows].float()[:, :, head_group]            # (b, q, h, n)
        Cs = C[:, rows].float()[:, :, head_group]
        a_cs = torch.cumsum(dts * Af, dim=1)
        y_c = torch.einsum("blhn,bhpn->blhp", Cs, state) \
            * torch.exp(a_cs)[..., None]
        q = xs.shape[1]
        causal = torch.ones(q, q, dtype=torch.bool, device=dev).tril()
        seg = a_cs.transpose(1, 2)[:, :, :, None] \
            - a_cs.transpose(1, 2)[:, :, None, :]            # (b, h, l, s)
        decay = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)),
                            0.0)
        w = torch.einsum("blhn,bshn->bhls", Cs, Bs) * decay \
            * dts.transpose(1, 2)[:, :, None, :]
        y_c = y_c + torch.einsum("bhls,bshp->blhp", w, xs) \
            + Df[None, None, :, None] * xs
        y[:, rows] = y_c.to(x.dtype)
        total = a_cs[:, -1]                                  # (b, h)
        Bw = Bs * (dts * torch.exp(total[:, None] - a_cs))[..., None]
        state = state * torch.exp(total)[:, :, None, None] \
            + torch.einsum("bshn,bshp->bhpn", Bw, xs)
    if out_state is not None:
        out_state.copy_(state)
        state = out_state
    return y, state


def ssd_fwd(x, dt, A, B, C, D, *, chunk: int = 128,
            out_state: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, h, p) bf16 or f32; dt: (b, s, h) f32; A, D: (h,); B, C:
    (b, s, g, n) in x's type. Returns (y, final_state); the final state
    (b, h, p, n) float32 is written into ``out_state`` when one is given
    (a decode cache's slice). B10 on CUDA tensors (the inputs made
    contiguous, A and D cast to float32), the plain version on CPU
    tensors."""
    if on_cpu(x, dt, A, B, C, D):
        return ssd_plain(x, dt, A, B, C, D, chunk=chunk, out_state=out_state)
    chunk = min(chunk, x.shape[1])
    return K.launch_ssd(x.contiguous(), dt.contiguous(),
                        A.float().contiguous(), B.contiguous(),
                        C.contiguous(), D.float().contiguous(), chunk,
                        out_state=out_state)
