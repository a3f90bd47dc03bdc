"""Production meshes and the H100's roofline constants.

A mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` with
``mesh_dim_names``. Meshes are built by FUNCTIONS (never module-level
constants), so importing this module touches no process group.

The reference's production meshes are TPU v5e pods: 16 × 16 chips on an
ICI torus, and two pods over DCN. Their H100 counterpart keeps the device
counts: ``(data 32, model 8)`` is 256 H100s, ``(pod 2, data 32, model
8)`` 512, with ``model`` inside one 8-GPU NVLink node (the torus does not
carry over). :func:`make_production_mesh` builds them on torch's
``"fake"`` process-group backend (``FakeStore``): one process stands for
every rank, collectives do nothing, and DTensor's sharding propagation
runs as it would on the real cluster. That is what the dry run needs.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist

PRODUCTION = {False: ((32, 8), ("data", "model")),
              True: ((2, 32, 8), ("pod", "data", "model"))}


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device_type: str = "cuda"):
    """A mesh of the default process group's ranks in row-major order;
    the group must hold ``prod(shape)`` ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"make_mesh {tuple(shape)}: no process group; "
                           f"call init_process_group first")
    if dist.get_world_size() != n:
        raise RuntimeError(f"make_mesh {tuple(shape)} needs {n} ranks, the "
                           f"process group has {dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def fake_world(n: int) -> None:
    """Make the default process group a ``"fake"`` one of ``n`` ranks,
    this process rank 0 (replacing a fake group of another size); raises
    if a real group is up."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is up; the fake world "
                               "is for the dry run's own process")
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def make_production_mesh(*, multi_pod: bool = False):
    """``(data 32, model 8)``, or ``(pod 2, data 32, model 8)`` with
    ``multi_pod``, on a fake process group of 256 or 512 ranks (host
    tensors: the dry run lays out ``meta`` tensors)."""
    shape, axes = PRODUCTION[multi_pod]
    fake_world(math.prod(shape))
    return make_mesh(shape, axes, device_type="cpu")


def mesh_name(multi_pod: bool) -> str:
    shape, _ = PRODUCTION[multi_pod]
    return "mesh" + "x".join(map(str, shape))


# H100 SXM constants (roofline denominators), from NVIDIA's data sheet,
# dense rates, at the card's full power limit; the cards that ran this
# repository's chip runs were NVIDIA H100 80GB HBM3 at a 700.00 W limit.
PEAK_FLOPS_BF16 = 989e12      # FLOP/s per GPU, tensor cores, bf16
HBM_BW = 3.35e12              # bytes/s per GPU
LINK_BW = 450e9               # bytes/s per GPU each way, NVLink 4
SMEM_BYTES = 227 * 1024       # shared memory a block can use
# torch.cuda.get_device_properties(0).total_memory on an NVIDIA H100
# 80GB HBM3 at 700.00 W (torch 2.11.0+cu128).
HBM_BYTES = 85_017_493_504
