"""PyTorch/CUDA port of the binocular-speculation simulator.

Same module layout as the JAX package it ports: ``core`` (policy engine),
``accel`` (assessment backends; the four assessment reductions are
hand-written CUDA kernels for Hopper), ``net`` (flat network), ``sim``
(discrete-event MapReduce/YARN simulator) and ``obs.trace`` (the trace
schema). The package imports torch, never jax.
"""
