"""Fault injectors (§IV.A: "To emulate temporary system faults, we
introduce delays in the progress of MapReduce tasks. To emulate node
failures, we disconnect the targeted compute nodes.").

All injectors are deterministic given the simulation's seed; triggers can
fire at absolute times or at job map-progress fractions (Fig. 4a injects a
node failure at 10 %..100 % of map progress).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.types import TaskState
from repro_torch.obs.trace import FAULT_CODES, K_FAULT
from repro_torch.sim.mapreduce import SimJob, Simulation


# ---------------------------------------------------------------------------
# Declarative fault scripts (DESIGN.md §16.4): one script, two worlds.
#
# A script is a list of plain tuples ``(kind, idx, x, y)`` — printable,
# picklable, and identical across every engine of the differential fuzz
# matrix AND across the sim/runtime boundary: ``apply_script`` interprets
# a script against the discrete-event simulator, while
# ``repro.runtime.chaos.ChaosController`` interprets the *same* tuples
# against live coordinator/host threads. ``idx`` selects the victim node
# (modulo cluster size) or rack/map index, ``x`` is a time or progress
# fraction in [0, 1], ``y`` a magnitude/duration scale in [0, 1].
#
# Runtime-only kinds (message-plane faults the discrete-event simulator
# has no wire for) degrade to their nearest sim-visible equivalent — the
# equivalence waivers are tabulated in DESIGN.md §16.4:
#   drop     -> link cut (messages lost both ways)
#   dup      -> no-op    (sim event delivery is exactly-once by construction)
#   reorder  -> no-op    (sim events are totally ordered by the calendar)
#   delay_hb -> heartbeat outage (late heartbeats look silent, then resume)
#   hang     -> slowdown to ~0 (compute stops, heartbeats continue)
# ---------------------------------------------------------------------------
SCRIPT_KINDS = ("crash", "crash_restore", "slow", "hb", "mof", "disk",
                "degrade", "cut", "part",
                # runtime-first kinds with sim waivers:
                "drop", "dup", "reorder", "delay_hb", "hang")


def apply_script(sim: Simulation, job: Optional[SimJob], script) -> None:
    """Arm every step of a declarative fault script against ``sim``."""
    for step in script:
        kind, idx, x, y = step
        nid = sim.cluster.node_ids[idx % len(sim.cluster.node_ids)]
        at = 10.0 + x * 200.0
        if kind == "degrade":
            # rack-switch degradation (no-op on flat: no uplinks)
            rack_switch_degrade_at(sim, idx, at, factor=0.02 + 0.2 * y,
                                   duration=45.0 + y * 150.0)
        elif kind in ("cut", "drop"):
            link_cut_at(sim, nid, at, duration=25.0 + y * 120.0)
        elif kind == "part":
            rack_partition_at(sim, idx, at, duration=20.0 + y * 90.0)
        elif kind == "crash":
            crash_node_at(sim, nid, at)
        elif kind == "crash_restore":
            crash_node_at(sim, nid, at, restore_after=20.0 + y * 100.0)
        elif kind == "slow":
            slow_node_at(sim, nid, at, factor=0.02 + 0.06 * y,
                         duration=30.0 + y * 150.0)
        elif kind == "hang":
            # compute stops while heartbeats continue: the liar node
            slow_node_at(sim, nid, at, factor=1e-3,
                         duration=30.0 + y * 150.0)
        elif kind in ("hb", "delay_hb"):
            heartbeat_outage_at(sim, nid, at, duration=15.0 + y * 60.0)
        elif kind == "mof":
            lose_mof_at_map_progress(sim, job, max(x, 0.05),
                                     max_stragglers=2 + int(y * 14))
        elif kind == "disk":
            disk_exception_on_map(sim, job, idx % 8, at_spill=1 + int(y * 3))
        elif kind in ("dup", "reorder"):
            pass  # exactly-once / totally-ordered by construction (§16.4)
        else:  # pragma: no cover - strategy bug guard
            raise ValueError(kind)


def crash_node_at(sim: Simulation, node_id: str, at: float,
                  restore_after: Optional[float] = None) -> None:
    sim.engine.at(at, sim.crash_node, node_id)
    if restore_after is not None:
        sim.engine.at(at + restore_after, sim.restore_node, node_id)


def slow_node_at(sim: Simulation, node_id: str, at: float, factor: float,
                 duration: Optional[float] = None) -> None:
    sim.engine.at(at, sim.set_node_speed, node_id, factor)
    if duration is not None:
        sim.engine.at(at + duration, sim.set_node_speed, node_id, 1.0)


def heartbeat_outage_at(sim: Simulation, node_id: str, at: float,
                        duration: float) -> None:
    """Transient network delay: the node keeps computing but its heartbeats
    vanish for ``duration`` — indistinguishable from a crash until it
    resumes (the Fig. 7(b) confusion matrix). Suppression windows only
    ever extend (overlapping outages — or an outage during a link cut —
    union; a short outage must not resume a severed link's heartbeats)."""
    def start():
        # Emit inside the existing callback — scheduling a separate obs
        # event would shift engine seq allocation and break the
        # obs-on ≡ obs-off byte-identity gate (DESIGN.md §18.2).
        if sim.obs is not None:
            sim.obs.emit(K_FAULT, a=sim.cluster._node_pos[node_id],
                         b=FAULT_CODES["hb"], f0=duration)
        node = sim.cluster.nodes[node_id]
        node.hb_suppressed_until = max(node.hb_suppressed_until,
                                       sim.engine.now + duration)
        sim._arr_node_supp(node_id)
    sim.engine.at(at, start)


def rack_switch_degrade_at(sim: Simulation, rack: int, at: float,
                           factor: float,
                           duration: Optional[float] = None) -> None:
    """Network-level fault (DESIGN.md §15.5): the rack's uplink switch
    degrades to ``factor`` of its capacity — every future inter-rack
    fetch touching the rack prices against the shrunken uplink, so the
    whole rack's shuffle health sags while its nodes stay perfectly
    alive (the degraded-network scenario the paper's glance ζ-scores
    must separate from a sick node). Overlapping windows on one rack
    union — the strongest active degrade wins, and the uplink heals
    only when every window has elapsed (same discipline as link cuts
    and heartbeat outages). No-op on topology-free networks
    (``net="flat"`` has no uplinks)."""
    net = sim.cluster.net
    key = rack % max(1, net.n_racks)

    def eff() -> float:
        reg = sim._degrade_windows.get(key, [])
        return min((f for _e, f in reg), default=1.0)

    def start():
        if sim.obs is not None:
            sim.obs.emit(K_FAULT, a=-1, b=FAULT_CODES["degrade"],
                         f0=factor, f1=float(key))
        end = (sim.engine.now + duration if duration is not None
               else float("inf"))
        sim._degrade_windows.setdefault(key, []).append((end, factor))
        net.set_uplink_factor(rack, eff())

    def stop():
        reg = sim._degrade_windows.get(key, [])
        now = sim.engine.now
        reg[:] = [(e, f) for e, f in reg if e > now + 1e-9]
        net.set_uplink_factor(rack, eff())

    sim.engine.at(at, start)
    if duration is not None:
        sim.engine.at(at + duration, stop)


def link_cut_at(sim: Simulation, node_id: str, at: float,
                duration: Optional[float] = None) -> None:
    """The node's network link goes down: fetch paths to/from it are
    lost (in-flight transfers abort into failure cycles, its MOF copies
    leave the candidate set) and its heartbeats vanish — while the node
    keeps computing. Restores after ``duration`` if given."""
    sim.engine.at(at, sim.cut_link, node_id, duration)
    if duration is not None:
        sim.engine.at(at + duration, sim.restore_link, node_id)


def rack_partition_at(sim: Simulation, rack: int, at: float,
                      duration: Optional[float] = None) -> None:
    """Whole-rack network partition: every node in the rack gets its
    link cut at ``at`` (coarse model: the MOF-availability index is
    consumer-independent, so intra-rack fetches are suppressed along
    with inter-rack ones — the §15.5 fidelity waiver), healing together
    after ``duration``."""
    def start():
        for nid in sim.cluster.net.rack_nodes(rack):
            sim.cut_link(nid, duration)
    def end():
        for nid in sim.cluster.net.rack_nodes(rack):
            sim.restore_link(nid)
    sim.engine.at(at, start)
    if duration is not None:
        sim.engine.at(at + duration, end)


def crash_busiest_node_at_map_progress(sim: Simulation, job: SimJob,
                                       frac: float,
                                       restore_after: Optional[float] = None
                                       ) -> None:
    """Fig. 1/4a scenario: when ``job`` reaches ``frac`` of map completions,
    disconnect the node hosting the most of its map work (attempts first,
    then MOFs) — the co-located small-job killer."""
    def fire():
        counts = {}
        for t in job.maps:
            for a in t.running_attempts():
                counts[a.node_id] = counts.get(a.node_id, 0) + 1
            for n in t.output_nodes:
                counts[n] = counts.get(n, 0) + 1
        if not counts:  # map phase fully drained; hit a MOF holder
            for t in job.maps:
                for n in t.output_nodes:
                    counts[n] = counts.get(n, 0) + 1
        if not counts:
            return
        victim = max(sorted(counts), key=lambda n: counts[n])
        sim.crash_node(victim)
        if restore_after is not None:
            sim.engine.after(restore_after, sim.restore_node, victim)
    if frac <= 0.0:
        # fire as soon as the job has placed its attempts
        sim.engine.at(job.spec.submit_time + 1.0, fire)
    else:
        job.map_progress_triggers.append((frac, fire))


def lose_mof_at_map_progress(sim: Simulation, job: SimJob, frac: float,
                             max_stragglers: int = 2) -> None:
    """Fig. 4b scenario: silently delete one completed map's MOF (node stays
    healthy) — pure dependency-oblivious territory.

    The paper post-selects runs "when there is at least one fetch failure of
    MOF but no map task failure": qualifying losses are ones some reducer
    still needs. We pre-select deterministically: the victim is a completed
    map whose partition ≥1 but ≤``max_stragglers`` running reducers have not
    fetched yet — few reporters means the AM's 3-report fuse burns through
    multiple full fetch cycles, the Hadoop stall behind the 4× slowdown.
    If no qualifying map exists yet, the injector re-arms shortly after.
    """
    def fire():
        # Wait until the shuffle is mostly drained, then hit the map with
        # the fewest (≥1) still-waiting reducers.
        need = done = 0
        for r in job.reduces:
            for a in r.running_attempts():
                need += len(a.task.deps)
                done += len(a.shuffle.fetched)
        unfinished = any(r.state != TaskState.COMPLETED
                         for r in job.reduces)
        if need == 0 or done / need < 0.75:
            if unfinished:
                sim.engine.after(1.0, fire)
            return
        best = None
        for t in job.maps:
            if t.state != TaskState.COMPLETED or not t.output_nodes:
                continue
            waiting = 0
            for r in job.reduces:
                for a in r.running_attempts():
                    # only original consumers count: a speculative copy
                    # that dies with its sibling can't produce the paper's
                    # qualifying fetch-failure condition
                    if not a.is_speculative \
                            and t.task_id not in a.shuffle.fetched:
                        waiting += 1
            if waiting >= 1 and (best is None or waiting < best[0]):
                best = (waiting, t)
        if best is None:
            if unfinished:
                sim.engine.after(1.0, fire)
            return
        sim.lose_mof(best[1])
    job.map_progress_triggers.append((frac, fire))


def disk_exception_on_map(sim: Simulation, job: SimJob, map_index: int,
                          at_spill: int) -> None:
    """Fig. 9 scenario: the map's attempt dies with a disk write exception
    right after producing ``at_spill`` spills (progress log survives)."""
    n = job.spec.n_spills
    # fail just past the at_spill-th spill boundary
    frac = min((at_spill + 0.02) / n, 0.999)

    def arm():
        if map_index >= len(job.maps):
            return
        t = job.maps[map_index]
        if sim.obs is not None:
            sim.obs.emit(K_FAULT, a=-1, b=FAULT_CODES["disk"],
                         f0=frac, obj=t.task_id)
        t.inject_disk_exception_at = frac
        # The first attempt may already be running (dispatch happens in the
        # submit event): inject directly and recompute its milestones.
        for a in t.running_attempts():
            if a.disk_exception_at is None:
                a.disk_exception_at = frac
                t.inject_disk_exception_at = None
                sim._schedule_map_milestone(a)
            break
    sim.engine.at(job.spec.submit_time, arm)
