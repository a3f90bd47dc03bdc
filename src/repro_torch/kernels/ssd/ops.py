"""Public SSD op: impl selection and the gradient's wiring.

``impl``:
- ``"kernel"`` — :func:`~repro_torch.kernels.ssd.ssd.ssd_fwd` (kernel B10
  on CUDA tensors, its plain version on CPU tensors). For :func:`ssd` it
  runs inside :class:`SSDFunction`, the counterpart of the reference's
  ``custom_vjp`` (``ops.py:25-43``): the forward is the kernel, the
  backward autograd of the torch oracle, exactly as the reference
  differentiates its Pallas forward. There is no backward kernel,
  because the reference has none. The default.
- ``"ref"``    — the plain torch oracle (``ref.ssd_reference``).

The reference package defaults to ``"ref"`` and selects its Pallas kernel
with ``"pallas"``/``"auto"``; the port defaults to the kernel, because
its main path on the card goes through its kernels. The single-token
decode is the oracle's recurrence, as in the reference.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention.ops import check_impl
from repro_torch.kernels.ssd import ref as _ref
from repro_torch.kernels.ssd import ssd as _ssd


class SSDFunction(torch.autograd.Function):
    """y of the SSD scan through B10 (its plain version on CPU tensors);
    the gradient is that of the oracle on the saved inputs."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, chunk):
        y, _ = _ssd.ssd_fwd(x, dt, A, B, C, D, chunk=chunk)
        ctx.save_for_backward(x, dt, A, B, C, D)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            y, _ = _ref.ssd_reference(*inputs, chunk=ctx.chunk)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(y, wanted, dy))
        return (*(next(grads) if t.requires_grad else None
                  for t in inputs), None)


def ssd(x, dt, A, B, C, D, *, chunk: int = 128,
        impl: str = "kernel") -> torch.Tensor:
    """Chunked SSD scan; returns y with x.shape (state discarded)."""
    if check_impl(impl) == "ref":
        return _ref.ssd_reference(x, dt, A, B, C, D, chunk=chunk)[0]
    return SSDFunction.apply(x, dt, A, B, C, D, chunk)


def ssd_with_state(x, dt, A, B, C, D, *, chunk: int = 128,
                   impl: str = "kernel",
                   out_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill entry point: returns (y, final_state) for decode handoff;
    the state goes into ``out_state`` when one is given."""
    if check_impl(impl) == "ref":
        y, state = _ref.ssd_reference(x, dt, A, B, C, D, chunk=chunk)
        if out_state is not None:
            state = out_state.copy_(state)
        return y, state
    return _ssd.ssd_fwd(x, dt, A, B, C, D, chunk=chunk, out_state=out_state)


ssd_decode_step = _ref.ssd_decode_step
