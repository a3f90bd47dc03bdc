"""Attention kernels of the model stack, each shipped as a triple, as in
the reference package (``repro.kernels``):

- ``<name>.py`` -- the public kernel function: on CUDA tensors it launches
  the hand-written CUDA kernel (built from ``accel/csrc/<name>.cu`` by
  :mod:`repro_torch.accel.kernels`, counted in its ``launches``), on CPU
  tensors it runs the kernel's plain torch version, which sits beside it
  and walks the same tiles;
- ``ops.py`` -- the public op: ``impl="kernel"`` (the default: the
  function above) or ``impl="ref"`` (the oracle);
- ``ref.py`` -- the plain torch oracle, a copy of the reference's
  ``ref.py``.

Kernels: ``flash_attention`` (prefill: B6, the GQA flash-attention
forward) and ``decode_attention`` (one token against the KV cache: B9).
The flash-attention backward (B7, B8) raises until the training slice
ports it; the Mamba-2 SSD scan (B10, ``ssd``) and the sequence-parallel
decode (``impl="dist"``) are not ported yet (ROADMAP Queue A/B).
"""
