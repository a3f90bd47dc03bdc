"""Rack-aware quasi-static network model (DESIGN.md §15.2).

Nodes are grouped into contiguous racks; every inter-rack fetch crosses
both rack uplinks in addition to the two endpoint NICs. Each uplink has
capacity ``nodes-per-rack × NIC / oversub`` (datacenter-style
oversubscription) scaled by a per-rack degradation factor
(``rack_switch_degrade_at``), and is shared quasi-statically across the
inter-rack flows touching that rack — the exact per-NIC discipline the
flat model applies per node, lifted to the uplink.

With one rack no flow is ever inter-rack, so the model degenerates to
:class:`~repro_torch.net.flat.FlatNetwork` byte-for-byte (enforced in
tests/test_net.py) — that equivalence also pins the generic
``open_flow`` path against BatchShuffle's inlined flat arithmetic.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.net.base import DEFAULT_OVERSUB, NetworkModel


class TopoNetwork(NetworkModel):
    name = "topo"

    def __init__(self, racks: int = 4, oversub: float = DEFAULT_OVERSUB,
                 uplink_bw: Optional[float] = None, **kw):
        super().__init__(**kw)
        assert racks >= 1, racks
        self.n_racks = int(racks)
        self.oversub = float(oversub)
        self._uplink_bw = uplink_bw
        self.uplink_cap = np.zeros(self.n_racks)

    def _post_bind(self) -> None:
        if self._uplink_bw is not None:
            cap = float(self._uplink_bw)
        else:
            per_rack = -(-len(self.node_ids) // self.n_racks)
            cap = per_rack * self.nic_bw / self.oversub
        self.uplink_cap = np.full(self.n_racks, cap)

    # ------------------------------------------------------------------
    def rate_probe(self, src: str, dst: str) -> float:
        if src == dst:
            return self.disk_bw / max(1, self.nodes[src].active_flows + 1)
        rate = min(
            self.nic_bw / max(1, self.nodes[src].active_flows + 1),
            self.nic_bw / max(1, self.nodes[dst].active_flows + 1))
        pos = self._node_pos
        rs = int(self.node_rack[pos[src]])
        rd = int(self.node_rack[pos[dst]])
        if rs != rd:
            up = self.uplink_cap * self.rack_factor
            flows = self.rack_flows
            rate = min(rate,
                       up[rs] / max(1, int(flows[rs]) + 1),
                       up[rd] / max(1, int(flows[rd]) + 1))
        return rate

    def open_flow(self, src: str, dst: str) -> float:
        rate = self.rate_probe(src, dst)
        self._count_open(src, dst)
        if src != dst:
            pos = self._node_pos
            rs = int(self.node_rack[pos[src]])
            rd = int(self.node_rack[pos[dst]])
            if rs != rd:
                self.rack_flows[rs] += 1
                self.rack_flows[rd] += 1
        return rate

    def close_flow(self, src: str, dst: str) -> None:
        self._count_close(src, dst)
        if src != dst:
            pos = self._node_pos
            rs = int(self.node_rack[pos[src]])
            rd = int(self.node_rack[pos[dst]])
            if rs != rd:
                self.rack_flows[rs] = max(0, int(self.rack_flows[rs]) - 1)
                self.rack_flows[rd] = max(0, int(self.rack_flows[rd]) - 1)

    # ------------------------------------------------------------------
    def _verify_extra(self, flows: Sequence[Tuple[str, str]]) -> None:
        pos = self._node_pos
        expect = np.zeros(self.n_racks, dtype=np.int64)
        for src, dst in flows:
            if src == dst:
                continue
            rs = int(self.node_rack[pos[src]])
            rd = int(self.node_rack[pos[dst]])
            if rs != rd:
                expect[rs] += 1
                expect[rd] += 1
        got = self.rack_flows.astype(np.int64)
        assert (got == expect).all(), (got.tolist(), expect.tolist())
