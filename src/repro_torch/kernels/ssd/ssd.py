"""Mamba-2 SSD chunked scan: kernel B10 and its plain torch versions.

:func:`ssd_fwd` is the port of the reference's ``ssd_pallas``
(``repro/kernels/ssd/ssd.py``). On CUDA tensors it launches B10, the CUDA
kernels in ``accel/csrc/ssd.cu``, which has two bodies
(``kernels.ssd_tc`` says which takes the inputs):

- bf16 with head_dim and d_state each 64 or 128 and a chunk of 64 to 256
  rows in steps of 64 (Mamba2-2.7B's layer): the Hopper body of
  ``csrc/ssd_sm90.cuh``, Mamba-2's chunked algorithm in three kernels —
  the chunk cumsum of dt·A and C·Bᵀ once per (sequence, chunk, group);
  each chunk's local state with the state pass in chunk order; each
  chunk's output, the chunks in parallel — every product on the tensor
  cores with bf16 operands and float32 sums. An operand the kernel
  computes (the weighted x, the scores, the carried state) goes in as a
  bf16 pair hi + lo. Its plain version is :func:`ssd_tc_plain`, which
  follows the same decomposition and rounds at the same places.
- float32 and the other shapes: the SIMT body, one block per (batch,
  head) walking the chunks in order with the (head_dim × d_state) state in
  shared memory, float32 throughout. Its plain version walks the same
  chunks for all (batch, head) at once with the kernel's arithmetic.

Both bodies and both plain versions take the chunk cumsum of dt·A in row
order with each product and sum rounded on its own
(:func:`_cumsum_rows`): within a 256-row chunk a_cs reaches hundreds, and
exp(a_cs[l] − a_cs[s]) turns a last-bit difference there into a relative
error of about 1e-4 in y, as large as float32's tolerance.

On CPU tensors :func:`ssd_plain` runs the plain version of the body that
would take the inputs.

Unlike the Pallas kernel, which asserts ``s % chunk == 0``, all of them
take a ragged tail with the oracle's semantics: the last chunk is
shorter, and rows past ``s`` (the oracle's zero padding, dt = 0) weigh
nothing and write nothing. The chunk is ``min(chunk, s)``, as in the
reference, except that a sequence of one chunk may run as one chunk of
``s`` rounded up to the Hopper body's 64-row tile (``kernels.ssd_chunk``):
the padding rows are the identity, so that is the same scan.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.accel import kernels as K
from repro_torch.accel.torch_backend import on_cpu


def _cumsum_rows(a: torch.Tensor, dim: int) -> torch.Tensor:
    """The inclusive cumsum of ``a`` along ``dim`` in row order, each sum
    rounded on its own, as B10's bodies take it (``torch.cumsum`` sums in
    another order or width on some devices: float64 on the CPU)."""
    out = torch.empty_like(a)
    run = torch.zeros_like(a.select(dim, 0))
    for r in range(a.shape[dim]):
        run = run + a.select(dim, r)
        out.select(dim, r).copy_(run)
    return out


def ssd_plain(x, dt, A, B, C, D, *, chunk: int = 128,
              out_state: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B10's plain version: (y in x's type, final state (b, h, p, n)
    float32). For the inputs of the Hopper body it is
    :func:`ssd_tc_plain`; for the rest it walks the chunks as the SIMT
    body computes them: the inclusive cumsum of dt·A in row order, the
    carried-state term C·stateᵀ·exp(a_cs), the causal pairs' (C·Bᵀ)·
    exp(a_cs[l] − a_cs[s])·dt_s (exp only where s ≤ l) against x, D·x,
    then state ← state·exp(total) + (B·dt·exp(total − a_cs))ᵀ·x. Float64
    inputs, which no kernel takes, run the same walk in float64 (y and
    the state float64): a witness for the float32 versions."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if h % g:
        raise ValueError(f"ssd: {h} heads do not split into {g} groups")
    chunk = K.ssd_chunk(x.dtype, p, n, s, chunk)
    if K.ssd_tc(x.dtype, p, n, chunk):
        return ssd_tc_plain(x, dt, A, B, C, D, chunk=chunk,
                            out_state=out_state)
    dev = x.device
    wide = torch.float64 if x.dtype == torch.float64 else torch.float32
    head_group = torch.arange(h, device=dev) // (h // g)
    Af, Df = A.to(wide), D.to(wide)
    # the cumsum of every chunk at once: (b, chunks, chunk, h), rows past
    # s zero
    nc = -(-s // chunk)
    dt_c = torch.nn.functional.pad(dt.to(wide), (0, 0, 0, nc * chunk - s))
    a_all = _cumsum_rows(dt_c.reshape(b, nc, chunk, h) * Af, 2)
    state = torch.zeros((b, h, p, n), dtype=wide, device=dev)
    y = torch.empty_like(x)
    for c0 in range(0, s, chunk):
        rows = slice(c0, min(c0 + chunk, s))
        xs = x[:, rows].to(wide)                             # (b, q, h, p)
        dts = dt[:, rows].to(wide)                           # (b, q, h)
        Bs = B[:, rows].to(wide)[:, :, head_group]           # (b, q, h, n)
        Cs = C[:, rows].to(wide)[:, :, head_group]
        a_cs = a_all[:, c0 // chunk, :xs.shape[1]]
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


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _pair(t: torch.Tensor) -> torch.Tensor:
    """t as the Hopper body hands it to the tensor cores: hi = bf16(t)
    plus lo = bf16(t - hi), summed in float32 (exactly)."""
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def ssd_tc_plain(x, dt, A, B, C, D, *, chunk: int = 128,
                 out_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of B10's Hopper body, in its decomposition
    (Mamba-2's chunked SSD), in chunks of ``chunk`` rows as given (a
    chunk above s is one padded chunk): per chunk (rows past s zero, dt =
    0)

    1. a_cs, the cumsum of dt·A in row order (each product and sum
       rounded on its own), and C·Bᵀ once per group;
    2. the local state S_c = (x·w)ᵀ·B with w = dt·exp(total − a_cs),
       from the chunk alone;
    3. the state pass in chunk order: state ← state·exp(total) + S_c;
    4. y = exp(a_cs[l])·C_l·state_in + P·x + D·x with P = (C·Bᵀ)·
       exp(a_cs[l] − a_cs[s])·dt_s where s ≤ l (exp only there).

    For bf16 inputs (the kernel's) each operand the kernel computes and
    hands to the tensor cores, x·w, the state entering a chunk and P, is
    a bf16 pair hi + lo (:func:`_pair`); for float32 inputs the same
    decomposition runs in float32 throughout."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if h % g:
        raise ValueError(f"ssd: {h} heads do not split into {g} groups")
    dev = x.device
    nc = -(-s // chunk)
    pad = nc * chunk - s
    head_group = torch.arange(h, device=dev) // (h // g)
    pair = _pair if x.dtype == torch.bfloat16 else (lambda t: t)

    def chunks(t):   # (b, s, ...) -> (b, nc, Q, ...), zero rows past s
        t = t.float()
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(b, nc, chunk, *t.shape[2:])

    xs, dts, Bs, Cs = chunks(x), chunks(dt), chunks(B), chunks(C)
    Af, Df = A.float(), D.float()
    # 1. the cumsum in row order
    a_cs = _cumsum_rows(dts * Af, 2)
    total = a_cs[:, :, -1]                                   # (b, nc, h)
    # 2. the local states, from each chunk alone: (x·w)ᵀ·B
    xw = pair(xs * (dts * torch.exp(total[:, :, None] - a_cs))[..., None])
    s_c = torch.einsum("bcshp,bcshn->bchpn", xw, Bs[:, :, :, head_group])
    # 3. the state pass, in chunk order, and 4. each chunk's output
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=dev).tril()
    for c in range(nc):
        rows = slice(c * chunk, min((c + 1) * chunk, s))
        q = rows.stop - rows.start
        Ch = Cs[:, c][:, :, head_group]                      # (b, Q, h, n)
        y_c = torch.einsum("blhn,bhpn->blhp", Ch, pair(state)) \
            * torch.exp(a_cs[:, c])[..., None]
        cb = torch.einsum("blgn,bsgn->bgls", Cs[:, c], Bs[:, c])
        a = a_cs[:, c].transpose(1, 2)                       # (b, h, Q)
        seg = a[:, :, :, None] - a[:, :, None, :]
        decay = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)),
                            0.0)
        P = pair(cb[:, head_group] * decay
                 * dts[:, c].transpose(1, 2)[:, :, None, :])
        y_c = y_c + torch.einsum("bhls,bshp->blhp", P, xs[:, c]) \
            + Df[None, None, :, None] * xs[:, c]
        y[:, rows] = y_c[:, :q].to(x.dtype)
        state = state * torch.exp(total[:, c])[:, :, None, None] + s_c[:, c]
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
    chunk = K.ssd_chunk(x.dtype, x.shape[3], B.shape[3], x.shape[1], chunk)
    return K.launch_ssd(x.contiguous(), dt.contiguous(),
                        A.float().contiguous(), B.contiguous(),
                        C.contiguous(), D.float().contiguous(), chunk,
                        out_state=out_state)
