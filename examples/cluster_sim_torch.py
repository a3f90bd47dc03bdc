"""The paper in one terminal screen, on the PyTorch/CUDA port: a 1 GB
Terasort job on a 20-node YARN cluster, one node crash at 50 % map
progress, under both speculation policies — with the recovery timeline
printed, plus a shuffle-substrate profile comparing the batched
macro-event fetch plane (the default) and the event-driven engine
against the seed's rescan path (fetch slots filled per unit of
candidate-selection work; DESIGN.md §12/§14).

The flags and printed lines are ``examples/cluster_sim.py``'s.
``--assess-backend {torch,numpy}`` runs the policies' assessment math
on the port's torch backend, the hand-written kernels B1–B4 on the CUDA
card by default, or on numpy
(byte-identical decisions, DESIGN.md §13), and prints the per-backend
assessment-tick profile; ``--sweep N`` demos the batched multi-scenario
sweep (one batched step scoring N fault scenarios vs scoring them
serially on numpy). ``--device cpu`` runs the torch backend's plain
versions on the CPU; without it the run needs a card and raises where
there is none.

    PYTHONPATH=src python examples/cluster_sim_torch.py
    PYTHONPATH=src python examples/cluster_sim_torch.py --sweep 8
    PYTHONPATH=src python examples/cluster_sim_torch.py --device cpu \\
        --assess-backend numpy --net fair --racks 4
"""
from __future__ import annotations

import argparse
import time

from repro_torch.accel.torch_backend import require_device
from repro_torch.sim import JobSpec, Simulation, faults


def backend_kw(assess_backend: str = "torch", device: str = "cuda",
               net: str = "flat") -> dict:
    """A ``Simulation``'s assessment backend, and on the fair network its
    bulk solver: torch on ``device`` for ``"torch"``, else numpy; a fresh
    instance each call, so no two simulations share a backend's state."""
    if assess_backend == "numpy":
        kw = {"assess_backend": "numpy"}
        bulk = "numpy"
    else:
        from repro_torch.accel.bulk import TorchBulk
        from repro_torch.accel.torch_backend import TorchBackend
        kw = {"assess_backend": TorchBackend(device)}
        bulk = TorchBulk(device)
    if net == "fair":
        kw["net_opts"] = {"bulk_backend": bulk}
    return kw


def run(policy: str, gb: float, frac: float, seed: int,
        shuffle: str = "batch", assess_backend: str = "torch",
        device: str = "cuda", net: str = "flat", racks: int = 0, obs=None,
        model=None):
    sim = Simulation(policy=policy, seed=seed, shuffle=shuffle, net=net,
                     racks=racks, obs=obs,
                     **backend_kw(assess_backend, device, net))
    if model is not None:
        sim.speculator.load_checkpoint(model)
    job = sim.submit(JobSpec("demo", "terasort", gb))
    faults.crash_busiest_node_at_map_progress(sim, job, frac)

    timeline = []
    orig = Simulation._start_attempt
    def patched(self, req, node_id):
        if req.speculative or req.rollback or req.reason:
            timeline.append((self.engine.now, f"launch {req.task.task_id} "
                             f"on {node_id} ({req.reason or 'speculative'}"
                             f"{'+rollback' if req.rollback else ''})"))
        return orig(self, req, node_id)
    Simulation._start_attempt = patched
    orig_nl = Simulation.node_lost
    def pnl(self, node_id, by_policy=False):
        timeline.append((self.engine.now,
                         f"node {node_id} declared lost "
                         f"({'policy Eq.4' if by_policy else 'NM expiry 600s'})"))
        return orig_nl(self, node_id, by_policy=by_policy)
    Simulation.node_lost = pnl
    try:
        sim.run()
    finally:
        Simulation._start_attempt = orig
        Simulation.node_lost = orig_nl
    return job.result, timeline, sim


def _print_shuffle_profile(batch_prof, gb: float, frac: float,
                           seed: int, net: str = "flat", racks: int = 0,
                           assess_backend: str = "torch",
                           device: str = "cuda") -> None:
    """The substrate win, demoed: same crashed run under all three
    engines — identical slots filled, orders of magnitude less selection
    work, and the batch plane's try_start fan-out collapsed by the
    completion log. ``batch_prof`` is reused from the main loop's yarn
    run; the rescan and event references are re-simulated."""
    _, _, rescan_sim = run("yarn", gb, frac, seed, shuffle="rescan",
                           assess_backend=assess_backend, device=device,
                           net=net, racks=racks)
    _, _, event_sim = run("yarn", gb, frac, seed, shuffle="event",
                          assess_backend=assess_backend, device=device,
                          net=net, racks=racks)
    rescan_prof = rescan_sim.shuffle.profile
    event_prof = event_sim.shuffle.profile
    print(f"\n=== shuffle substrate profile (same run, three engines, "
          f"net={net}) ===")
    print(f"{'engine':>8} {'slots':>7} {'notifies':>9} {'try_start':>10} "
          f"{'selection work':>16} {'slots/1k work':>14}")
    for mode, prof in (("rescan", rescan_prof), ("event", event_prof),
                       ("batch", batch_prof)):
        work = (f"{prof.deps_scanned} scanned" if mode == "rescan"
                else f"{prof.heap_pops} heap pops")
        print(f"{mode:>8} {prof.slots_filled:>7} {prof.notifies:>9} "
              f"{prof.try_calls:>10} {work:>16} "
              f"{prof.slots_per_kwork():>14.1f}")
    ratio = rescan_prof.selection_work \
        / max(1, event_prof.selection_work)
    same = (rescan_prof.slots_filled == event_prof.slots_filled
            == batch_prof.slots_filled
            and rescan_prof.notifies == event_prof.notifies
            == batch_prof.notifies)
    behaviour = ("identical fetch behaviour" if same
                 else ("fair model: per-engine recompute cadence shifts "
                       "fetch behaviour (expected, DESIGN.md §15.3)"
                       if net == "fair"
                       else "ENGINES DIVERGED (file a bug!)"))
    print(f"  → {behaviour} with {ratio:.0f}× less "
          f"candidate-selection work (O(1) pops vs O(n_maps) rescans); "
          f"batch applied {batch_prof.lane_records} lane records and "
          f"skipped {event_prof.try_calls - batch_prof.try_calls} "
          f"no-op try_starts")


def _print_assess_profile(profiles) -> None:
    """Per-backend assessment-tick profile: same scenario, same actions,
    different compute substrate (DESIGN.md §13)."""
    print("\n=== assessment-backend profile (same yarn run) ===")
    print(f"{'backend':>8} {'ticks':>7} {'assess wall':>12} "
          f"{'ticks/s':>9} {'actions':>8}")
    for name, sim in profiles:
        tps = sim.assess_ticks / max(sim.assess_wall, 1e-9)
        print(f"{name:>8} {sim.assess_ticks:>7} "
              f"{sim.assess_wall * 1e3:>10.1f}ms {tps:>9.0f} "
              f"{sim.actions_emitted:>8}")


def _demo_degraded_rack(gb: float, seed: int, net: str, racks: int,
                        assess_backend: str = "torch",
                        device: str = "cuda") -> None:
    """The paper's degraded-network scenario end-to-end: rack 0's
    uplink switch sickens to 2 % capacity mid-shuffle — no node ever
    dies, but every cross-rack fetch touching the rack crawls. Binocular
    speculation's glance sees the whole rack's fetch plane sag (ζ), not
    a single sick node (DESIGN.md §15.5)."""
    print(f"\n=== degraded-rack demo: {gb:g} GB terasort on {racks} "
          f"racks (net={net}), rack 0 uplink -> 2% at t=45s ===")
    for policy in ("yarn", "bino"):
        sim = Simulation(policy=policy, seed=seed, net=net, racks=racks,
                         **backend_kw(assess_backend, device, net))
        job = sim.submit(JobSpec("deg", "terasort", gb))
        base = Simulation(policy=policy, seed=seed, net=net, racks=racks,
                          **backend_kw(assess_backend, device, net))
        base.submit(JobSpec("deg", "terasort", gb))
        base_jct = base.run()[0].jct
        faults.rack_switch_degrade_at(sim, 0, 45.0, 0.02, duration=300.0)
        res = sim.run()[0]
        print(f"  {policy.upper():>5}: JCT {res.jct:7.0f}s "
              f"({res.jct / base_jct:4.1f}x vs healthy rack), "
              f"{res.n_fetch_failures} fetch failures, "
              f"{res.n_spec_attempts} speculative attempts, "
              f"0 nodes lost")


def _demo_sweep(n_scenarios: int, seed: int, net: str = "flat",
                racks: int = 0, assess_backend: str = "torch",
                device: str = "cuda") -> None:
    """Batched multi-scenario sweep on a mid-run multi-job snapshot: the
    batched step (B1, B3 and B4 once each with a scenario axis) on
    ``device`` against the clones scored one by one on numpy."""
    import dataclasses

    from repro_torch.accel.sweep import BatchedSweep, scenario_grid
    from repro_torch.sim.mapreduce import SimParams

    params = dataclasses.replace(SimParams(), sim_time_cap=80.0)
    sim = Simulation(policy="yarn", seed=seed, params=params, net=net,
                     racks=racks, **backend_kw(assess_backend, device, net))
    for j in range(3):
        sim.submit(JobSpec(f"j{j}", "terasort", 2.0,
                           submit_time=float(3 * j)))
    sim.run()
    scenarios = scenario_grid(n_scenarios, len(sim.cluster.node_ids),
                              seed=seed,
                              n_racks=sim.cluster.net.n_racks)
    sweep = BatchedSweep(sim.arrays, sim.engine.now).prepare(scenarios)
    sweep.run_batched(device)  # the kernels' first call builds them
    t0 = time.perf_counter()
    batched = sweep.run_batched(device)
    tb = time.perf_counter() - t0
    t0 = time.perf_counter()
    sweep.run_serial()
    ts = time.perf_counter() - t0
    print(f"\n=== batched sweep: {n_scenarios} fault scenarios, "
          f"one device step ===")
    for sc, verdict in zip(scenarios, batched):
        hits = int(verdict["spatial_hits"].sum())
        failed = int(verdict["failed"].sum())
        spec = int((verdict["late_victims"] >= 0).sum())
        print(f"  {sc.kind:>12}: spatial_hits={hits} failed_nodes={failed} "
              f"late_victims={spec} reaps={verdict['n_reap']}")
    print(f"  serial numpy {ts * 1e3:.1f}ms → batched {tb * 1e3:.1f}ms "
          f"({ts / max(tb, 1e-9):.1f}x)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gb", type=float, default=1.0)
    ap.add_argument("--frac", type=float, default=0.5,
                    help="map progress at which the node crashes")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--assess-backend", default="torch",
                    choices=("torch", "numpy"),
                    help="assessment-compute backend (DESIGN.md §13): "
                         "torch on --device, or numpy")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of the torch backend and the sweep's "
                         "batched step (default: the CUDA card)")
    ap.add_argument("--policy", default=None, choices=("predictor",),
                    help="add a third policy column to the crash demo: "
                         "the learned PredictorPolicy (DESIGN.md §20); "
                         "requires --model")
    ap.add_argument("--model", default=None, metavar="CKPT_DIR",
                    help="trained predictor checkpoint directory "
                         "(make train-predictor -> artifacts/predictor/"
                         "ckpt); loads the calibrated threshold from its "
                         "metadata")
    ap.add_argument("--net", default="flat",
                    choices=("flat", "topo", "fair"),
                    help="network model (DESIGN.md §15): flat per-NIC "
                         "shares (seed-exact), rack-aware topo, or "
                         "batched ε-fair flows")
    ap.add_argument("--racks", type=int, default=0,
                    help="rack count for the topology-aware models "
                         "(default: 4 for topo, 1 for fair)")
    ap.add_argument("--sweep", type=int, default=0, metavar="N",
                    help="demo the batched sweep across N fault scenarios")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record the bino run with the flight recorder "
                         "and export a Chrome/Perfetto trace "
                         "(DESIGN.md §18; see examples/TRACES.md)")
    args = ap.parse_args(argv)
    if args.policy == "predictor" and not args.model:
        ap.error("--policy predictor requires --model CKPT_DIR "
                 "(make train-predictor)")
    require_device(args.device, "cluster_sim_torch")
    dev = dict(assess_backend=args.assess_backend, device=args.device)

    # fault-free baseline
    sim0 = Simulation(policy="yarn", seed=args.seed, net=args.net,
                      racks=args.racks, **backend_kw(**dev, net=args.net))
    sim0.submit(JobSpec("demo", "terasort", args.gb))
    base = sim0.run()[0].jct

    print(f"=== {args.gb:g} GB terasort, node crash at "
          f"{args.frac:.0%} map progress (net={args.net}, "
          f"fault-free JCT {base:.0f}s) ===")
    yarn_sim = None
    recorder = None
    policies = ("yarn", "bino") + \
        (("predictor",) if args.policy == "predictor" else ())
    for policy in policies:
        obs = None
        if args.trace and policy == "bino":
            from repro_torch.obs import TraceRecorder
            obs = recorder = TraceRecorder()
        model = args.model if policy == "predictor" else None
        res, timeline, sim = run(policy, args.gb, args.frac, args.seed,
                                 net=args.net, racks=args.racks, obs=obs,
                                 model=model, **dev)
        if policy == "yarn":
            yarn_sim = sim
        print(f"\n--- {policy.upper()} ---  JCT {res.jct:.0f}s "
              f"({res.jct / base:.1f}x slowdown), "
              f"{res.n_spec_attempts} speculative attempts")
        for t, line in timeline[:12]:
            print(f"  t={t:7.1f}s  {line}")
        if len(timeline) > 12:
            print(f"  ... {len(timeline) - 12} more events")

    _print_shuffle_profile(yarn_sim.shuffle.profile, args.gb, args.frac,
                           args.seed, net=args.net, racks=args.racks, **dev)
    profiles = [(args.assess_backend, yarn_sim)]
    if args.assess_backend != "numpy":
        _, _, ref = run("yarn", args.gb, args.frac, args.seed,
                        assess_backend="numpy", net=args.net,
                        racks=args.racks)
        profiles.insert(0, ("numpy", ref))
    _print_assess_profile(profiles)
    n_racks = yarn_sim.cluster.net.n_racks
    if n_racks > 1:
        # cross-rack traffic needs a job bigger than one rack: pack-
        # first placement fills ~8 maps/node, so a job of `gb` GB spans
        # ~gb nodes — size it one node past the rack boundary
        per_rack = -(-len(yarn_sim.cluster.node_ids) // n_racks)
        _demo_degraded_rack(max(args.gb, per_rack + 1.0), args.seed,
                            args.net, n_racks, **dev)
    if args.sweep:
        _demo_sweep(args.sweep, args.seed, net=args.net, racks=args.racks,
                    **dev)
    if recorder is not None:
        from repro_torch.obs import scorecard, write_chrome_trace
        path = write_chrome_trace(recorder, args.trace,
                                  node_names=sim.cluster.node_ids)
        card = scorecard(recorder, policy="bino")
        print("\n=== flight recorder (bino run) ===")
        print(f"  {len(recorder)} records "
              f"({recorder.dropped} dropped), counts: "
              + ", ".join(f"{k}={v}"
                          for k, v in sorted(recorder.counts().items())))
        print(f"  scorecard: recall={card['recall']} "
              f"precision={card['precision']} ttd={card['ttd']} "
              f"wasted_backup_work={card['wasted_backup_work']}")
        print(f"  wrote {path} — open in https://ui.perfetto.dev "
              f"(examples/TRACES.md)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
