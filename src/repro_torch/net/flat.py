"""The seed's flat per-NIC share model, extracted verbatim (DESIGN.md
§15.1) — the default network and the bit-exactness anchor.

``rate_probe`` is byte-for-byte ``Cluster.fetch_throughput`` from the
seed: local reads hit the disk, remote fetches share each endpoint NIC
across that node's active flows, all quasi-static (decided at flow
start, never re-allocated). ``open_flow`` pairs the probe with the flow
registration the shuffle engines used to do inline.

Seed-compat accounting (default): a local fetch increments the one
node's counter twice — once as "source", once as "destination" — so
co-located flows weigh double in every later share decision (the
asymmetric accounting, DESIGN.md §15.4). ``seed_compat=False`` applies the
symmetric fix (each flow counts once per distinct endpoint); action
traces shift wherever reducers fetch MOFs from their own node, which is
why the fix ships behind the flag (§15.4).
"""
from __future__ import annotations

from repro_torch.net.base import DISK_BW, NIC_BW, NetworkModel


class FlatNetwork(NetworkModel):
    name = "flat"

    @property
    def inline_flat(self) -> bool:  # type: ignore[override]
        # BatchShuffle's hand-inlined fast path IS the seed-compat
        # arithmetic over the module-constant bandwidths; a symmetric-
        # fix or custom-capacity flat model must take the generic path
        # (the inline code bakes NIC_BW/DISK_BW in).
        return (self.seed_compat and self.nic_bw == NIC_BW
                and self.disk_bw == DISK_BW)

    def rate_probe(self, src: str, dst: str) -> float:
        """Quasi-static per-flow rate for a shuffle fetch, decided at
        flow start (the seed ``Cluster.fetch_throughput``)."""
        if src == dst:
            return self.disk_bw / max(1, self.nodes[src].active_flows + 1)
        s = self.nic_bw / max(1, self.nodes[src].active_flows + 1)
        d = self.nic_bw / max(1, self.nodes[dst].active_flows + 1)
        return min(s, d)

    def open_flow(self, src: str, dst: str) -> float:
        rate = self.rate_probe(src, dst)
        self._count_open(src, dst)
        return rate

    def close_flow(self, src: str, dst: str) -> None:
        self._count_close(src, dst)
