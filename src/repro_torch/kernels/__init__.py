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

Kernels: ``flash_attention`` (B6, the GQA flash-attention forward of
every family's attention layers, causal or not (hubert-xlarge's encoder
at head_dim 80), and its backward B7 (dK, dV) and B8 (dQ) behind an
``autograd.Function``), ``decode_attention`` (one token against the KV
cache: B9, the decode of the dense, moe, hybrid and vlm families) and
``ssd`` (B10, the Mamba-2 SSD chunked scan of the ssm and hybrid stacks'
prefill; its gradient is autograd of the oracle, as in the reference).
The MoE layers have no kernel: their router and expert products are
plain torch, as they are plain jnp in the reference. Not ported yet
(ROADMAP): B7, B8 and B9 at head_dim 80, and the sequence-parallel decode
(``decode_attention(impl="dist")``).
"""
