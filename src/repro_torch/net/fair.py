"""Batched ε-fair flow model (DESIGN.md §15.3) — the opt-in fidelity
trade that removes the per-flow sequential core of the quasi-static rule.

The flat/topo models decide every launch rate from the endpoints' *live*
flow counts, so each fetch launch must observe the previous completion's
bookkeeping — the measured 1000-node bottleneck (ROADMAP): the batch
lane's fused drain cannot reorder or coalesce around that dependency.
``FairNetwork`` replaces the per-launch observation with an **ε-fair
(max-min) allocation over columnar flow/link tables**, recomputed
vectorized **once per BatchQueue drain** (``begin_drain``); every launch
inside the drain prices against the drain-start equilibrium — O(links
per flow) array reads, no recompute, no sequential observation.

Links: one NIC per node, one disk per node (local reads), one uplink
per rack (capacity ``nodes-per-rack × NIC / oversub`` × degradation
factor). A flow crosses its endpoint NICs plus, when inter-rack, both
rack uplinks; local flows cross the disk only. The water-fill freezes
all links within ``(1+ε)`` of each round's bottleneck share together
(ε=0 → exact max-min); per-flow equilibrium rates and per-link shares
come out of the same solve. Properties (capacity, work conservation,
monotonicity under removal, flat agreement on degenerate 1-rack
patterns) are hypothesis-tested in tests/test_net.py.

``recompute="flow"`` re-solves before *every* launch — the per-flow
accounting baseline the ``perf_net`` benchmark gates the drained mode
against (≥ 1.5× end-to-end at 1000 nodes on the batch engine).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.net.base import DEFAULT_OVERSUB, NetworkModel
from repro_torch.obs.trace import K_FLOW_BULK

_INIT_FLOWS = 256


class FairNetwork(NetworkModel):
    name = "fair"
    wants_drain_hook = True

    def __init__(self, racks: int = 1, oversub: float = DEFAULT_OVERSUB,
                 uplink_bw: float = None, eps: float = 0.05,
                 recompute: str = "drain", bulk: bool = True,
                 bulk_backend=None, realloc: bool = False, **kw):
        # The fair model carries no seed-compat burden: flows count once
        # per distinct endpoint (the symmetric accounting).
        kw.setdefault("seed_compat", False)
        super().__init__(**kw)
        assert racks >= 1, racks
        assert recompute in ("drain", "flow"), recompute
        self.n_racks = int(racks)
        self.oversub = float(oversub)
        self._uplink_bw = uplink_bw
        self.eps = float(eps)
        self.recompute_mode = recompute
        # Columnar flow table (grow-by-doubling + freelist; a slot's
        # links row is the flow's full link membership, -1 padded).
        cap = _INIT_FLOWS
        self.f_links = np.full((cap, 4), -1, dtype=np.int32)
        self.f_active = np.zeros(cap, dtype=bool)
        self.f_rate = np.zeros(cap)
        self.f_si = np.zeros(cap, dtype=np.int32)   # endpoint positions:
        self.f_di = np.zeros(cap, dtype=np.int32)   # the bulk link source
        self._free: List[int] = []
        self._hi = 0                      # slots ever touched
        self.n_flows = 0
        self._pair: Dict[Tuple[str, str], List[int]] = {}
        # Link tables (built at bind: [node NICs | node disks | uplinks]).
        self.link_cap = np.zeros(0)
        self.link_share = np.zeros(0)
        self.link_nflows = np.zeros(0, dtype=np.int32)
        self._dirty = True
        self._frozen = False
        self._lane_seen = False           # a BatchQueue drain ever ran
        self.n_recomputes = 0             # solver invocations (profiling)
        # Bulk mode (DESIGN.md §17.2): while a drain holds the shares
        # frozen, opens/closes stage only the scalar flow-table fields
        # (si/di/active/pair) and ``end_drain`` rebuilds the link/count
        # tables in one vectorized step; the water-fill delegates to a
        # repro_torch.accel.bulk backend (``bulk_backend``: None or
        # "torch" solves and prices on the CUDA card and raises without
        # one; CPU runs pass "numpy" or ``TorchBulk("cpu")``). Armed by
        # ``enable_bulk()`` — only the kernel drain calls it, so
        # batch-engine traces (the perf baseline) never change.
        # ``bulk=False`` in net_opts keeps even the kernel engine on the
        # incremental path (the differential bulk-vs-incremental pin in
        # the fuzz suite).
        self._bulk_opt = bool(bulk)
        self._bulk_backend_spec = bulk_backend
        self._bulk = False
        self._backend = None
        self._stale = False               # staged table updates pending
        # Staged open/close tallies since the last end_drain — the bulk
        # path bypasses ``_count_open``/``_count_close`` (and thus their
        # per-flow obs records); end_drain emits one K_FLOW_BULK summary.
        self._staged_opens = 0
        self._staged_closes = 0
        self.last_slot = -1               # slot of the latest open_flow
        # Drain-boundary re-allocation of in-flight transfers (§17.4
        # waiver): opt-in; consumed by KernelShuffle, not by this class.
        self.realloc = bool(realloc)

    @property
    def supports_bulk(self) -> bool:
        # flow-mode recomputes *inside* every open: incompatible with
        # staging the tables until end-of-drain
        return self._bulk_opt and self.recompute_mode == "drain"

    def enable_bulk(self) -> None:
        assert self.recompute_mode == "drain", self.recompute_mode
        assert self.n_flows == 0, "enable_bulk() before any traffic"
        if self._bulk:
            return
        from repro_torch.accel.bulk import get_bulk_backend
        self._backend = get_bulk_backend(self._bulk_backend_spec)
        self._bulk = True

    # ------------------------------------------------------------------
    def _post_bind(self) -> None:
        n = len(self.node_ids)
        if self._uplink_bw is not None:
            up = float(self._uplink_bw)
        else:
            per_rack = -(-n // self.n_racks)
            up = per_rack * self.nic_bw / self.oversub
        self.link_cap = np.concatenate([
            np.full(n, self.nic_bw),          # 0..n-1     node NICs
            np.full(n, self.disk_bw),         # n..2n-1    node disks
            np.full(self.n_racks, up),        # 2n..       rack uplinks
        ])
        self.link_share = self._eff_cap()
        self.link_nflows = np.zeros(len(self.link_cap), dtype=np.int32)
        # Python-scalar rack lookup for the kernel drain's inlined
        # staged-open pricing (the layout is fixed after bind).
        self._rack_py = self.node_rack.tolist()
        self._dirty = True

    def _eff_cap(self) -> np.ndarray:
        eff = self.link_cap.copy()
        n2 = 2 * len(self.node_ids)
        eff[n2:] *= self.rack_factor
        return eff

    def _capacity_changed(self) -> None:
        self._dirty = True

    # ------------------------------------------------------------------
    def _flow_link_list(self, src: str, dst: str) -> List[int]:
        pos = self._node_pos
        si = pos[src]
        n = len(self.node_ids)
        if src == dst:
            return [n + si]                   # local read: disk only
        di = pos[dst]
        rs = int(self.node_rack[si])
        rd = int(self.node_rack[di])
        links = [si, di]
        if rs != rd:
            links.append(2 * n + rs)
            links.append(2 * n + rd)
        return links

    def _alloc(self) -> int:
        if self._free:
            return self._free.pop()
        slot = self._hi
        if slot == len(self.f_active):
            cap = 2 * len(self.f_active)
            links = np.full((cap, 4), -1, dtype=np.int32)
            links[:slot] = self.f_links[:slot]
            self.f_links = links
            for name in ("f_active", "f_rate", "f_si", "f_di"):
                col = getattr(self, name)
                new = np.zeros(cap, dtype=col.dtype)
                new[:slot] = col[:slot]
                setattr(self, name, new)
        self._hi = slot + 1
        return slot

    # ------------------------------------------------------------------
    def open_flow(self, src: str, dst: str) -> float:
        pos = self._node_pos
        si = pos[src]
        di = si if src == dst else pos[dst]
        if self._frozen and self._bulk:
            # Staged open: the drain prices against frozen shares, so
            # the link/count tables are dead until ``end_drain`` rebuilds
            # them — record only the endpoints and the frozen price.
            slot = self._alloc()
            self.last_slot = slot
            self.f_si[slot] = si
            self.f_di[slot] = di
            self.f_active[slot] = True
            self.n_flows += 1
            self._pair.setdefault((src, dst), []).append(slot)
            self._stale = True
            self._staged_opens += 1
            share = self.link_share
            n = len(self.node_ids)
            if si == di:
                r = share[n + si]
            else:
                r = share[si]
                x = share[di]
                if x < r:
                    r = x
                rs = self.node_rack[si]
                rd = self.node_rack[di]
                if rs != rd:
                    n2 = 2 * n
                    x = share[n2 + rs]
                    if x < r:
                        r = x
                    x = share[n2 + rd]
                    if x < r:
                        r = x
            return float(r) if r > 1.0 else 1.0
        links = self._flow_link_list(src, dst)
        slot = self._alloc()
        self.last_slot = slot
        row = self.f_links[slot]
        row[:] = -1
        row[:len(links)] = links
        self.f_si[slot] = si
        self.f_di[slot] = di
        self.f_active[slot] = True
        self.n_flows += 1
        n2 = 2 * len(self.node_ids)
        for l in links:
            self.link_nflows[l] += 1
            if l >= n2:
                self.rack_flows[l - n2] += 1
        self._pair.setdefault((src, dst), []).append(slot)
        self._count_open(src, dst)
        self._dirty = True
        if self.recompute_mode == "flow":
            # per-flow accounting: re-solve with the new flow included
            # and charge it its exact equilibrium rate
            self._recompute()
            return max(float(self.f_rate[slot]), 1.0)
        if self._dirty and not self._frozen and not self._lane_seen:
            # no calendar lane drives this model (rescan/event engines):
            # fall back to per-event recompute so shares never go stale
            self._recompute()
        return max(float(self.link_share[links].min()), 1.0)

    def close_flow(self, src: str, dst: str) -> None:
        slots = self._pair.get((src, dst))
        assert slots, (src, dst)
        slot = slots.pop()
        if not slots:
            del self._pair[(src, dst)]
        if self._frozen and self._bulk:
            # Staged close (see open_flow): only the slot dies now; the
            # count tables catch up in the end_drain rebuild.
            self.f_active[slot] = False
            self.f_rate[slot] = 0.0
            self.n_flows -= 1
            self._free.append(slot)
            self._stale = True
            self._staged_closes += 1
            return
        row = self.f_links[slot]
        n2 = 2 * len(self.node_ids)
        for l in row:
            if l < 0:
                break
            self.link_nflows[l] -= 1
            if l >= n2:
                self.rack_flows[l - n2] -= 1
        self.f_active[slot] = False
        self.f_rate[slot] = 0.0
        self.n_flows -= 1
        self._free.append(slot)
        self._count_close(src, dst)
        self._dirty = True

    def rate_probe(self, src: str, dst: str) -> float:
        if self._dirty and not self._frozen:
            self._recompute()
        links = self._flow_link_list(src, dst)
        return max(float(self.link_share[links].min()), 1.0)

    # ------------------------------------------------------------------
    def begin_drain(self) -> None:
        self._lane_seen = True
        if self._dirty:
            self._recompute()
        self._frozen = True

    def end_drain(self) -> None:
        self._frozen = False
        if self._stale:
            self._stale = False
            self._rebuild_tables()
            # flows changed during the drain: the next begin_drain (or
            # rate_probe) re-solves — the incremental path's cadence
            self._dirty = True
            if self.obs is not None:
                self.obs.emit(K_FLOW_BULK, b=self.n_flows,
                              f0=float(self._staged_opens),
                              f1=float(self._staged_closes))
        self._staged_opens = 0
        self._staged_closes = 0

    def _rebuild_tables(self) -> None:
        """Catch the link/count tables up with the drain's staged
        opens/closes in one vectorized pass over the active flows:
        derive every flow's link row from its endpoints, bincount the
        per-link/rack loads, and diff-sync the per-node counters (the
        ``node_flows``/``rack_flows`` stores are aliased into
        ``ArraySnapshot`` — all writes in place). Runs between the
        drain and the next heap event, so no reader can observe the
        mid-drain staleness."""
        n = len(self.node_ids)
        n2 = 2 * n
        idx = np.flatnonzero(self.f_active[: self._hi])
        si = self.f_si[idx]
        di = self.f_di[idx]
        local = si == di
        rs = self.node_rack[si]
        rd = self.node_rack[di]
        inter = ~local & (rs != rd)
        L = np.empty((len(idx), 4), dtype=np.int32)
        L[:, 0] = np.where(local, n + si, si)
        L[:, 1] = np.where(local, -1, di)
        L[:, 2] = np.where(inter, n2 + rs, -1)
        L[:, 3] = np.where(inter, n2 + rd, -1)
        self.f_links[idx] = L
        self.link_nflows[:] = np.bincount(L[L >= 0],
                                          minlength=len(self.link_cap))
        self.rack_flows[:] = self.link_nflows[n2:]
        newc = np.bincount(si, minlength=n) + \
            np.bincount(di[~local], minlength=n)
        changed = np.flatnonzero(newc != self.node_flows)
        if len(changed):
            nodes = self.nodes
            ids = self.node_ids
            self.node_flows[changed] = newc[changed]
            for i in changed.tolist():
                nodes[ids[i]].active_flows = int(newc[i])

    # ------------------------------------------------------------------
    def _recompute(self) -> None:
        """ε-fair max-min water-fill, vectorized over the flow/link
        tables. Per round: every live link's equal share is its
        remaining capacity over its unfrozen flow count; the global
        minimum share saturates its link(s) — all links within
        ``(1+ε)`` of it freeze together, their flows pinned at the
        bottleneck share. ≤ one round per distinct bottleneck; ε merges
        near-ties so faulted 1000-node states stay a handful of rounds."""
        self.n_recomputes += 1
        self._dirty = False
        eff = self._eff_cap()
        nL = len(eff)
        idx = np.flatnonzero(self.f_active[: self._hi])
        share = eff.copy()
        if not len(idx):
            self.link_share = share
            return
        L = self.f_links[idx]
        valid = L >= 0
        if self._backend is not None:
            # bulk mode: the water-fill itself sits behind the pluggable
            # solver (numpy backend ≡ the loop below, bit-for-bit)
            share, rate = self._backend.waterfill(eff, L, valid, self.eps)
            self.f_rate[idx] = rate
            self.link_share = share
            return
        flat_links = np.where(valid, L, 0)
        k = len(idx)
        rem = eff.copy()
        rate = np.zeros(k)
        alive = np.ones(k, dtype=bool)
        was_bott = np.zeros(nL, dtype=bool)
        eps1 = 1.0 + self.eps
        while True:
            a_links = flat_links[alive][valid[alive]]
            if not len(a_links):
                break
            cnt = np.bincount(a_links, minlength=nL)
            live = cnt > 0
            s_all = np.where(live, rem / np.maximum(cnt, 1), np.inf)
            s = float(s_all.min())
            bott = live & (s_all <= s * eps1)
            hit = alive & (bott[flat_links] & valid).any(axis=1)
            rate[hit] = s
            h_links = flat_links[hit][valid[hit]]
            rem = np.maximum(rem - np.bincount(h_links, minlength=nL) * s,
                             0.0)
            share[bott] = s
            was_bott |= bott
            alive &= ~hit
        # Links that never bottlenecked expose their residual headroom
        # (what one more flow could claim there before other links bind).
        free = ~was_bott
        share[free] = rem[free]
        self.f_rate[idx] = rate
        self.link_share = share

    # ------------------------------------------------------------------
    def flow_rates(self) -> np.ndarray:
        """Equilibrium rates of the active flows (slot order) as of the
        last recompute — the property-test surface."""
        idx = np.flatnonzero(self.f_active[: self._hi])
        return self.f_rate[idx].copy()

    def active_flow_links(self) -> np.ndarray:
        idx = np.flatnonzero(self.f_active[: self._hi])
        return self.f_links[idx].copy()

    # ------------------------------------------------------------------
    def _verify_extra(self, flows: Sequence[Tuple[str, str]]) -> None:
        assert self.n_flows == len(flows), (self.n_flows, len(flows))
        expect = np.zeros(len(self.link_cap), dtype=np.int64)
        racks = np.zeros(self.n_racks, dtype=np.int64)
        n2 = 2 * len(self.node_ids)
        for src, dst in flows:
            for l in self._flow_link_list(src, dst):
                expect[l] += 1
                if l >= n2:
                    racks[l - n2] += 1
        got = self.link_nflows.astype(np.int64)
        assert (got == expect).all(), \
            (np.flatnonzero(got != expect).tolist())
        assert (self.rack_flows.astype(np.int64) == racks).all(), \
            (self.rack_flows.tolist(), racks.tolist())
        n_pair = sum(len(v) for v in self._pair.values())
        assert n_pair == self.n_flows, (n_pair, self.n_flows)
        assert int(self.f_active[: self._hi].sum()) == self.n_flows
        assert not self._stale, "staged bulk updates leaked past a drain"
        pos = self._node_pos
        for (src, dst), slots in self._pair.items():
            si, di = pos[src], pos[dst]
            for s in slots:
                assert bool(self.f_active[s]), (src, dst, s)
                assert int(self.f_si[s]) == si, (src, dst, s)
                assert int(self.f_di[s]) == di, (src, dst, s)
