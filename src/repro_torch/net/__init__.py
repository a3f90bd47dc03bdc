"""Network substrate (DESIGN.md §15). Only ``flat`` — the seed-exact
per-NIC share and the simulator's default — is ported; ``topo`` and
``fair`` wait (ROADMAP)."""
from repro_torch.net.base import (
    DEFAULT_OVERSUB,
    DISK_BW,
    NIC_BW,
    NetworkModel,
    make_network,
)
from repro_torch.net.flat import FlatNetwork

__all__ = [
    "DEFAULT_OVERSUB", "DISK_BW", "FlatNetwork", "NIC_BW", "NetworkModel",
    "make_network",
]
