"""Kernels of the model stack, each shipped as a triple, as in the
reference package (``repro.kernels``):

- ``<name>.py`` -- the public kernel function: on CUDA tensors it launches
  the hand-written CUDA kernel (built from ``accel/csrc/<name>.cu`` by
  :mod:`repro_torch.accel.kernels`, counted in its ``launches``), on CPU
  tensors it runs the kernel's plain torch version, which sits beside it
  and walks the same tiles;
- ``ops.py`` -- the public op: ``impl="kernel"`` (the default: the
  function above) or ``impl="ref"`` (the oracle);
- ``ref.py`` -- the plain torch oracle, a copy of the reference's
  ``ref.py``.

Kernels: ``flash_attention`` (B6, the GQA flash-attention forward, and
its backward B7 (dK, dV) and B8 (dQ) behind an ``autograd.Function``),
``decode_attention`` (one token against the KV cache: B9) and ``ssd``
(B10, the Mamba-2 SSD chunked scan of the ssm stack's prefill; its
gradient is autograd of the oracle, as in the reference). The
sequence-parallel decode (``decode_attention(impl="dist")``) is not
ported yet (ROADMAP Queue A).
"""
