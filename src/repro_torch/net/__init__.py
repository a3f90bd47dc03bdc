"""Pluggable topology-aware network substrate (DESIGN.md §15).

``flat`` (seed-exact per-NIC shares, the default), ``topo`` (rack-aware
quasi-static with oversubscribed uplinks), ``fair`` (batched ε-fair
max-min shares recomputed per BatchQueue drain). Select per simulation:
``Simulation(net="topo", racks=4)``.
"""
from repro_torch.net.base import (
    DEFAULT_OVERSUB,
    DISK_BW,
    NIC_BW,
    NetworkModel,
    make_network,
)
from repro_torch.net.fair import FairNetwork
from repro_torch.net.flat import FlatNetwork
from repro_torch.net.topo import TopoNetwork

__all__ = [
    "DEFAULT_OVERSUB", "DISK_BW", "FairNetwork", "FlatNetwork", "NIC_BW",
    "NetworkModel", "TopoNetwork", "make_network",
]
