"""Network substrate for the simulated cluster (DESIGN.md §15).

The seed modeled the shuffle network as one quasi-static per-node NIC
share with no topology: every fetch launch read the endpoints' live flow
counts, divided, and scheduled the transfer at that frozen rate
(``Cluster.fetch_throughput``). That model is byte-for-byte preserved as
:class:`~repro_torch.net.flat.FlatNetwork` — the default and the bit-exactness
anchor — while this package makes the network *pluggable*:

- ``topo`` (rack-aware, oversubscribed uplinks) and ``fair`` (batched
  ε-fair shares re-solved per drain) are not ported yet:
  :func:`make_network` raises for them (ROADMAP, port queue: "fair
  network + sweep").

Every model owns the authoritative flow bookkeeping (``SimNode.
active_flows`` plus the columnar ``node_flows``/``rack_flows``/... ride
the §11 write-through discipline: ``ArraySnapshot.init_net`` aliases the
model's arrays so one store serves both, and ``verify_arrays``/
``Simulation.verify_network`` check them against a from-scratch recount
of the live transfers).

Link faults (``sim/faults.py``): ``rack_switch_degrade_at`` scales a
rack uplink's capacity for future rate decisions; ``link_cut_at`` /
``rack_partition_at`` take fetch paths down entirely — modeled as
aborted transfers plus MOF-source suppression (an unreachable copy must
*not* schedule an almost-infinite transfer; it must burn failure
cycles, which is the recovery machinery the paper studies).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.trace import K_FLOW_CLOSE, K_FLOW_OPEN

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.sim.cluster import Cluster

# 1 GbE effective goodput and a single SATA disk (the paper's testbed,
# §IV.A). ``repro_torch.sim.cluster`` re-exports these — the net layer sits
# below the simulator and must not import it.
NIC_BW = 117e6          # bytes/s
DISK_BW = 100e6         # bytes/s (local MOF read)

# Datacenter-typical rack oversubscription: uplink capacity defaults to
# (nodes-per-rack × NIC) / OVERSUB.
DEFAULT_OVERSUB = 4.0

# Floor for degraded uplink factors: a zero-capacity link would schedule
# infinite transfers; total loss is expressed via link cuts instead.
MIN_FACTOR = 1e-3


class NetworkModel:
    """Pluggable flow-level network model.

    Contract (shared by all implementations):

    - ``open_flow(src, dst) -> rate`` registers one shuffle transfer and
      returns its quasi-static rate (bytes/s, decided at flow start —
      the engine schedules the completion event from it);
    - ``close_flow(src, dst)`` releases one transfer of that pair;
    - ``rate_probe(src, dst)`` answers what a new flow would get *now*
      without registering anything (the seed ``fetch_throughput`` API);
    - ``begin_drain``/``end_drain`` bracket a BatchQueue drain run —
      only :class:`FairNetwork` uses them (``wants_drain_hook``);
    - ``cut``/``restore_link`` maintain the link-down mirror; the
      simulation layer owns the recovery semantics (aborts, MOF-source
      suppression);
    - ``node_reset`` re-syncs a node's columns after ``SimNode.restore``.

    ``inline_flat`` gates BatchShuffle's hand-inlined flat fast path:
    only the seed-compat flat model may claim it (the inline code *is*
    the seed arithmetic).
    """

    name = "base"
    inline_flat = False
    wants_drain_hook = False
    # Optional flight recorder (repro_torch.obs); Simulation._wire_obs sets it.
    # Class-level None keeps the per-flow branch one attribute load.
    obs = None
    # Models that can stage flow bookkeeping across a drain and apply it
    # in one vectorized end-of-drain step (FairNetwork's bulk mode,
    # DESIGN.md §17.2) advertise it here; the kernel drain engine calls
    # ``enable_bulk()`` when True.
    supports_bulk = False

    def __init__(self, *, nic_bw: float = NIC_BW, disk_bw: float = DISK_BW,
                 seed_compat: bool = True):
        self.nic_bw = float(nic_bw)
        self.disk_bw = float(disk_bw)
        # Seed-compat flow accounting: the seed registered a *local*
        # fetch on "both" endpoints — i.e. twice on the one node (the
        # asymmetric double-count of DESIGN.md §15.4). ``seed_compat=False``
        # counts each flow once per distinct endpoint (the fix); traces
        # shift wherever reducers fetch co-located MOFs, so the compat
        # behavior stays the default (DESIGN.md §15.4).
        self.seed_compat = bool(seed_compat)
        self.nodes: Dict[str, object] = {}
        self.node_ids: List[str] = []
        self._node_pos: Dict[str, int] = {}
        self.n_racks = 1
        # Columnar write-through arrays (aliased into ArraySnapshot by
        # ``init_net`` — one store serves model and snapshot).
        self.node_flows = np.zeros(0, dtype=np.int32)
        self.node_link_up = np.ones(0, dtype=bool)
        self.node_rack = np.zeros(0, dtype=np.int32)
        self.rack_flows = np.zeros(1, dtype=np.int32)
        self.rack_factor = np.ones(1)

    # -- wiring ----------------------------------------------------------
    def bind(self, cluster: "Cluster") -> None:
        self.nodes = cluster.nodes
        self.node_ids = cluster.node_ids
        self._node_pos = cluster._node_pos
        n = len(self.node_ids)
        self.node_flows = np.zeros(n, dtype=np.int32)
        self.node_link_up = np.ones(n, dtype=bool)
        self.node_rack = self._rack_layout(n)
        self.rack_flows = np.zeros(self.n_racks, dtype=np.int32)
        self.rack_factor = np.ones(self.n_racks)
        self._post_bind()

    def _rack_layout(self, n: int) -> np.ndarray:
        """Contiguous rack blocks: rack r = nodes[r*k:(r+1)*k]."""
        if self.n_racks <= 1:
            return np.zeros(n, dtype=np.int32)
        per = -(-n // self.n_racks)  # ceil
        return (np.arange(n, dtype=np.int32) // per).astype(np.int32)

    def _post_bind(self) -> None:
        """Model-specific capacity tables (after the layout exists)."""

    # -- topology queries -------------------------------------------------
    def rack_of(self, node_id: str) -> int:
        return int(self.node_rack[self._node_pos[node_id]])

    def rack_nodes(self, rack: int) -> List[str]:
        rack = rack % max(1, self.n_racks)
        return [self.node_ids[i]
                for i in np.flatnonzero(self.node_rack == rack)]

    # -- flow lifecycle ---------------------------------------------------
    def open_flow(self, src: str, dst: str) -> float:
        raise NotImplementedError

    def close_flow(self, src: str, dst: str) -> None:
        raise NotImplementedError

    def rate_probe(self, src: str, dst: str) -> float:
        raise NotImplementedError

    # -- drain bracketing (FairNetwork) -----------------------------------
    def begin_drain(self) -> None:  # pragma: no cover - trivial default
        pass

    def end_drain(self) -> None:  # pragma: no cover - trivial default
        pass

    # -- fault hooks ------------------------------------------------------
    def set_uplink_factor(self, rack: int, factor: float) -> None:
        """Scale a rack uplink's capacity (switch degradation). Future
        rate decisions see the new capacity; in-flight transfers keep
        their quasi-static rates. No-op on topology-free models."""
        if self.n_racks <= 1:
            return
        rack = rack % self.n_racks
        self.rack_factor[rack] = max(float(factor), MIN_FACTOR)
        self._capacity_changed()

    def _capacity_changed(self) -> None:
        pass

    def cut(self, node_id: str) -> None:
        self.node_link_up[self._node_pos[node_id]] = False

    def restore_link(self, node_id: str) -> None:
        self.node_link_up[self._node_pos[node_id]] = True

    def link_down(self, node_id: str) -> bool:
        return not bool(self.node_link_up[self._node_pos[node_id]])

    def node_reset(self, node_id: str) -> None:
        """Node restored after a crash: its flow bookkeeping restarts
        from the (already torn down) clean slate."""
        self.node_flows[self._node_pos[node_id]] = \
            self.nodes[node_id].active_flows

    # -- shared accounting helpers ---------------------------------------
    def _count_open(self, src: str, dst: str) -> None:
        """Register one flow on the per-node counters + mirror. In
        seed-compat mode a local flow (src == dst) counts twice on its
        one node — the seed behavior; symmetric mode counts once per
        distinct endpoint."""
        pos = self._node_pos
        nf = self.node_flows
        s = self.nodes[src]
        if self.obs is not None:
            self.obs.emit(K_FLOW_OPEN, a=pos[src], b=pos[dst])
        if src == dst:
            s.active_flows += 2 if self.seed_compat else 1
            nf[pos[src]] = s.active_flows
            return
        d = self.nodes[dst]
        s.active_flows += 1
        d.active_flows += 1
        nf[pos[src]] = s.active_flows
        nf[pos[dst]] = d.active_flows

    def _count_close(self, src: str, dst: str) -> None:
        pos = self._node_pos
        nf = self.node_flows
        s = self.nodes[src]
        if self.obs is not None:
            self.obs.emit(K_FLOW_CLOSE, a=pos[src], b=pos[dst])
        if src == dst:
            k = 2 if self.seed_compat else 1
            s.active_flows = max(0, s.active_flows - k)
            nf[pos[src]] = s.active_flows
            return
        d = self.nodes[dst]
        s.active_flows = max(0, s.active_flows - 1)
        d.active_flows = max(0, d.active_flows - 1)
        nf[pos[src]] = s.active_flows
        nf[pos[dst]] = d.active_flows

    # -- consistency ------------------------------------------------------
    def expected_node_counts(
            self, flows: Sequence[Tuple[str, str]]) -> np.ndarray:
        """Per-node flow counts a from-scratch recount of ``flows``
        (live (src, dst) transfers) yields under this model's
        accounting rules."""
        pos = self._node_pos
        counts = np.zeros(len(self.node_ids), dtype=np.int64)
        local_k = 2 if self.seed_compat else 1
        for src, dst in flows:
            if src == dst:
                counts[pos[src]] += local_k
            else:
                counts[pos[src]] += 1
                counts[pos[dst]] += 1
        return counts

    def verify(self, flows: Sequence[Tuple[str, str]],
               link_down: Optional[set] = None) -> None:
        """Assert the incrementally-maintained counters equal a recount
        from the authoritative transfer list (the §11 gate's network
        half; conftest.check_invariants calls this mid-run)."""
        expect = self.expected_node_counts(flows)
        for i, nid in enumerate(self.node_ids):
            got = self.nodes[nid].active_flows
            assert got == expect[i], (nid, got, int(expect[i]))
            assert int(self.node_flows[i]) == got, (nid, got)
        if link_down is not None:
            for i, nid in enumerate(self.node_ids):
                assert bool(self.node_link_up[i]) == (nid not in link_down), \
                    nid
        self._verify_extra(flows)

    def _verify_extra(self, flows: Sequence[Tuple[str, str]]) -> None:
        pass


def make_network(spec, *, racks: int = 0, **opts) -> NetworkModel:
    """Resolve a network spec: an instance passes through; ``"flat"``
    (default) builds the seed-exact model. ``"topo"`` and ``"fair"`` are
    not ported yet and raise."""
    if isinstance(spec, NetworkModel):
        return spec
    from repro_torch.net.flat import FlatNetwork
    if spec in (None, "flat"):
        return FlatNetwork(**opts)
    if spec in ("topo", "fair"):
        raise NotImplementedError(
            f"network model {spec!r} is not ported yet (ROADMAP, port "
            f"queue: 'fair network + sweep'); use net='flat'")
    raise ValueError(f"unknown network model: {spec!r}")
