"""Simulated cluster: nodes with containers, disks, NICs, heartbeats.

Calibrated to the paper's testbed (§IV.A): 21 nodes (one dedicated to
RM/NameNode → 20 workers), 1 GbE, one 500 GB disk, 24 GB RAM / 24 cores
per node. Containers default to 8 per worker — the YARN 2.7-era
(24 GB, 2–3 GB/container) sizing that lets an 8-map 1 GB job land entirely
on ONE node, which is exactly the co-location behind the paper's
scope-limited myopia (§II.D.2).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Set

# 1 GbE effective goodput and a single SATA disk — the single source now
# lives in the network layer (repro_torch.net.base); re-exported here for the
# seed API (shuffle imports these names from this module).
from repro_torch.net.base import DISK_BW, NIC_BW, NetworkModel  # noqa: F401
from repro_torch.net.flat import FlatNetwork

HEARTBEAT_PERIOD = 1.0  # NodeManager → ResourceManager (s)


@dataclasses.dataclass
class SimNode:
    node_id: str
    n_containers: int = 8
    # Execution-speed multiplier: 1 = healthy, <1 = delayed, 0 = dead.
    speed: float = 1.0
    alive: bool = True
    # Containers in use (attempt ids).
    busy: Set[str] = dataclasses.field(default_factory=set)
    # MOFs present on the local disk: producer task_id → bytes.
    mofs: Dict[str, float] = dataclasses.field(default_factory=dict)
    # Spill logs for speculative rollback: task_id → offset fraction.
    spill_logs: Dict[str, float] = dataclasses.field(default_factory=dict)
    # Active network flows touching this node (for bandwidth sharing).
    active_flows: int = 0
    last_heartbeat: float = 0.0
    # Transient network outage: heartbeats suppressed until this time
    # (node keeps computing — the Fig. 7(b) delay-vs-crash confusion).
    hb_suppressed_until: float = 0.0

    def heartbeat_suppressed(self, now: float) -> bool:
        # Single source of the suppression rule. The per-second RM tick
        # (Simulation._heartbeat_tick) inlines this comparison over its
        # 1000-node loop — keep the two in sync if the rule changes.
        return now < self.hb_suppressed_until

    @property
    def free_containers(self) -> int:
        if not self.alive:
            return 0
        return self.n_containers - len(self.busy)

    def fail(self) -> None:
        """Node crash: heartbeats stop, local MOFs and spill logs are gone."""
        self.alive = False
        self.speed = 0.0
        self.mofs.clear()
        self.spill_logs.clear()

    def restore(self) -> None:
        self.alive = True
        self.speed = 1.0
        self.busy.clear()
        self.active_flows = 0


class Cluster:
    def __init__(self, n_workers: int = 20, n_containers: int = 8,
                 network: Optional[NetworkModel] = None):
        self.nodes: Dict[str, SimNode] = {
            f"n{i:02d}": SimNode(f"n{i:02d}", n_containers)
            for i in range(n_workers)
        }
        self.node_ids: List[str] = list(self.nodes)
        self._node_pos: Dict[str, int] = {
            n: i for i, n in enumerate(self.node_ids)}
        # Pluggable network substrate (DESIGN.md §15): owns the flow
        # accounting and every rate decision. The flat model is the
        # seed's quasi-static per-NIC share, extracted verbatim.
        self.net: NetworkModel = network if network is not None \
            else FlatNetwork()
        self.net.bind(self)
        # Free-container index: a lazy min-heap of node positions that MAY
        # have a free container. Invariant: every alive node with a free
        # container is flagged in the heap; stale entries (consumed slots,
        # dead nodes) are dropped at pop time. ``note_free`` re-arms a node
        # whenever an event can open a slot (complete/kill/crash-teardown/
        # restore), so the global placement scan is O(log n) per launch
        # instead of O(n_workers).
        self._free_heap: List[int] = list(range(n_workers))
        self._in_heap: List[bool] = [True] * n_workers

    def fetch_throughput(self, src: str, dst: str) -> float:
        """Quasi-static rate a new shuffle fetch would get right now —
        answered by the pluggable network model (the seed formula lives
        on as ``repro_torch.net.flat.FlatNetwork.rate_probe``)."""
        return self.net.rate_probe(src, dst)

    def note_free(self, node_id: str) -> None:
        """Re-arm ``node_id`` in the free-container index. Called by the
        substrate wherever a container may have opened (attempt complete/
        kill/fail teardown, node restore); a no-op while the node has no
        free slot or is already armed."""
        i = self._node_pos[node_id]
        if self._in_heap[i]:
            return
        n = self.nodes[node_id]
        if n.alive and n.free_containers > 0:
            heapq.heappush(self._free_heap, i)
            self._in_heap[i] = True

    def pick_container(self, preference: List[str],
                       exclude: Optional[Set[str]] = None) -> Optional[str]:
        """First node with a free container: preference order first, then
        pack-first over the cluster (deterministic; co-locates small jobs).

        The pack-first scan pops the free-container heap instead of
        walking every node: the heap yields candidates in node order, so
        the choice matches the seed's linear scan exactly (property-tested
        in tests/test_cluster_index.py). Excluded-but-free nodes are
        re-pushed after the query — exclusion is per-call state."""
        exclude = exclude or set()
        for nid in preference:
            n = self.nodes.get(nid)
            if n is not None and n.alive and nid not in exclude \
                    and n.free_containers > 0:
                return nid
        chosen: Optional[str] = None
        excluded_free: List[int] = []
        heap = self._free_heap
        while heap:
            i = heap[0]
            nid = self.node_ids[i]
            n = self.nodes[nid]
            if not n.alive or n.free_containers <= 0:
                heapq.heappop(heap)          # stale entry: slot consumed
                self._in_heap[i] = False
                continue
            if nid in exclude:
                heapq.heappop(heap)          # still free; restore below
                excluded_free.append(i)
                continue
            chosen = nid
            break
        for i in excluded_free:
            heapq.heappush(heap, i)
        return chosen
