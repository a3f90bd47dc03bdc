"""The torch port's network models and bulk solver against the reference.

1. **Topo** — in the port, a 1-rack topology is the flat network byte
   for byte under every shuffle engine; a 4-rack topology under the
   crash + MOF-loss harness gives the reference's traces.
2. **Fair** — the kernel engine on the ε-fair network, 4 racks, over the
   ``PINNED_FAIR`` fault corpus of ``tests/test_fuzz_equivalence.py``:
   the port with ``bulk_backend="numpy"`` and with ``TorchBulk("cpu")``
   emits the reference's traces, attempt launches and results, with and
   without drain-boundary re-pricing (``realloc``). A run whose flow
   table grows inside a drain (more than 256 flows) gives the same trace
   on the fused drain as on the record-at-a-time drain.
3. **Bulk solver** — ``TorchBulk("cpu")`` water-fill and pricing are
   bit-equal to ``NumpyBulk`` on every call recorded from a fair run and
   on random tables with ε ∈ {0, 0.05}; ``price_ref`` (B5's plain
   version) equals ``NumpyBulk.price`` on boundary inputs.
4. **Against Pallas** — ``price_ref`` equals the reference's
   ``PallasBulk`` pricing kernel in interpret mode, and the torch
   water-fill the reference's ``JaxBulk``, in a child process that
   restores ``jax.experimental.enable_x64`` (this process never patches
   jax).
5. **On the card** (marked ``cuda``; they skip without one) — B5 against
   ``price_ref``, and ``TorchBulk("cuda")`` against numpy.
6. **The chip smoke's fair scenario** at a reduced size matches the
   reference.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.sim as ref_sim
import repro_torch.sim as port_sim
from repro_torch.accel import bulk as B
from repro_torch.accel import kernels as K
from repro_torch.accel.bulk import NumpyBulk, TorchBulk
from repro_torch.accel.torch_backend import TorchBackend
from test_fuzz_equivalence import FAIR_RACKS, NET_GB, PINNED_FAIR
from test_torch_sim import _crash_mof, assert_same_run, run_traced

ROOT = Path(__file__).resolve().parents[1]
SHUFFLES = ("rescan", "event", "batch", "kernel")
FAIR_IDS = [p[0] for p in PINNED_FAIR]


def _script(script):
    def fault(pkg, sim, job):
        pkg.faults.apply_script(sim, job, script)
    return fault


# ---------------------------------------------------------------------------
# 1. Topo
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", SHUFFLES)
@pytest.mark.parametrize("policy", ["yarn", "bino"])
def test_topo_one_rack_is_flat_in_port(policy, mode):
    flat = run_traced(port_sim, policy, _crash_mof, seed=3, gb=1.0,
                      mode=mode, assess_backend="numpy")
    topo = run_traced(port_sim, policy, _crash_mof, seed=3, gb=1.0,
                      mode=mode, assess_backend="numpy", net="topo",
                      racks=1)
    assert flat[0], "scenario produced no actions — not probing"
    assert_same_run(flat, topo)


@pytest.mark.parametrize("mode", ["batch", "kernel"])
@pytest.mark.parametrize("policy", ["yarn", "bino"])
def test_topo_four_racks_matches_reference(policy, mode):
    ref = run_traced(ref_sim, policy, _crash_mof, seed=3, gb=NET_GB,
                     mode=mode, assess_backend="numpy", net="topo",
                     racks=4)
    port = run_traced(port_sim, policy, _crash_mof, seed=3, gb=NET_GB,
                      mode=mode, assess_backend=TorchBackend("cpu"),
                      net="topo", racks=4)
    assert ref[1], "scenario launched nothing — not probing"
    assert_same_run(ref, port)


# ---------------------------------------------------------------------------
# 2. Fair: the PINNED_FAIR corpus, port vs reference
# ---------------------------------------------------------------------------
def _fair(pkg, policy, seed, script, backend, bulk, realloc, sims=None):
    opts = {"realloc": realloc}
    if bulk is not None:
        opts["bulk_backend"] = bulk
    return run_traced(pkg, policy, _script(script), seed=seed, gb=NET_GB,
                      mode="kernel", assess_backend=backend, net="fair",
                      racks=FAIR_RACKS, net_opts=opts, sim_out=sims)


@pytest.mark.parametrize("realloc", [False, True],
                         ids=["frozen", "realloc"])
@pytest.mark.parametrize("bulk", ["numpy", "torch-cpu"])
@pytest.mark.parametrize("name,policy,seed,script", PINNED_FAIR,
                         ids=FAIR_IDS)
def test_fair_pinned_matches_reference(name, policy, seed, script, bulk,
                                       realloc):
    ref_sims, port_sims = [], []
    ref = _fair(ref_sim, policy, seed, script, "numpy", None, realloc,
                ref_sims)
    if bulk == "numpy":
        port = _fair(port_sim, policy, seed, script, "numpy", "numpy",
                     realloc, port_sims)
    else:
        port = _fair(port_sim, policy, seed, script, TorchBackend("cpu"),
                     TorchBulk("cpu"), realloc, port_sims)
    assert ref[1], "scenario launched nothing — not probing"
    assert_same_run(ref, port)
    rs, ps = ref_sims[0], port_sims[0]
    assert ps.cluster.net.n_recomputes == rs.cluster.net.n_recomputes > 0
    assert ps.shuffle.n_reallocs == rs.shuffle.n_reallocs
    if realloc:
        assert ps.shuffle.n_reallocs > 0, "nothing re-priced — not probing"
    if bulk != "numpy":
        solver = ps.cluster.net._backend
        assert solver.n_calls > 0 and solver.n_rounds >= solver.n_calls
        assert (solver.n_prices > 0) == realloc


def _grown(pkg, realloc, bulk=True, generic=False, bulk_backend=None):
    """Six 10 GB jobs on 100 nodes: more than 256 concurrent flows, so
    the fair network's flow table grows, also inside drains (through
    fault handlers and completions that re-enter ``try_start``)."""
    import dataclasses
    opts = {"realloc": realloc, "bulk": bulk}
    if bulk_backend is not None:
        opts["bulk_backend"] = bulk_backend
    sim = pkg.Simulation(
        policy="bino", seed=0, n_workers=100, n_containers=8,
        assess_backend="numpy", shuffle="kernel", net="fair", racks=4,
        net_opts=opts, record_actions=True,
        params=dataclasses.replace(pkg.BINO_PARAMS, sim_time_cap=150.0))
    if generic:
        sim.shuffle.batches._drain_impl = sim.shuffle.batches._generic_drain
    jobs = [sim.submit(pkg.JobSpec(f"j{i}", "terasort", 10.0,
                                   submit_time=float(i)))
            for i in range(6)]
    pkg.faults.crash_busiest_node_at_map_progress(sim, jobs[0], 0.4)
    pkg.faults.lose_mof_at_map_progress(sim, jobs[1], 1.0)
    pkg.faults.rack_switch_degrade_at(sim, rack=3, at=60.0, factor=0.05,
                                      duration=90.0)
    for t in range(20, 150, 13):
        sim.engine.at(float(t), sim.verify_network)
    results = sim.run()
    return sim, (sim.action_trace, [(r.job_id, r.finish_time, r.n_attempts)
                                    for r in results])


@pytest.mark.parametrize("realloc", [False, True],
                         ids=["frozen", "realloc"])
def test_fair_drain_survives_flow_table_growth(realloc):
    # The fused drain caches the flow-table columns; a growth inside the
    # drain must not leave it writing to the old, shorter arrays.
    sim, fused = _grown(port_sim, realloc, bulk_backend="numpy")
    assert len(sim.cluster.net.f_active) > 256
    assert fused[0], "scenario produced no actions — not probing"
    _s, generic = _grown(port_sim, realloc, generic=True,
                         bulk_backend="numpy")
    _s, ref_generic = _grown(ref_sim, realloc, generic=True)
    assert fused == generic == ref_generic
    if not realloc:
        # scalar per-flow accounting (no staging at all)
        _s, scalar = _grown(port_sim, realloc, bulk=False)
        assert fused == scalar


# ---------------------------------------------------------------------------
# 3. Bulk solver: TorchBulk on the CPU vs NumpyBulk
# ---------------------------------------------------------------------------
class _Recorder(NumpyBulk):
    def __init__(self):
        self.fills, self.prices = [], []

    def waterfill(self, eff, links, valid, eps):
        self.fills.append((eff.copy(), links.copy(), valid.copy(), eps))
        return super().waterfill(eff, links, valid, eps)

    def price(self, share, links, valid):
        self.prices.append((share.copy(), links.copy(), valid.copy()))
        return super().price(share, links, valid)


_CALLS = {}


def recorded_calls():
    """Every water-fill and pricing call of one re-pricing fair run of
    the port (crash during shuffle, 4 racks), cached per process."""
    if not _CALLS:
        rec = _Recorder()
        name, policy, seed, script = PINNED_FAIR[0]
        _fair(port_sim, policy, seed, script, "numpy", rec, True)
        _CALLS.update(fills=rec.fills, prices=rec.prices)
    return _CALLS


def random_table(rng, n=12, racks=3, k=40, eps=0.0):
    """A fair-network flow table: NICs, disks and uplinks of ``n`` nodes
    in ``racks`` racks; local (disk-only), intra-rack and inter-rack
    flows; degraded uplinks."""
    nL = 2 * n + racks
    eff = np.concatenate([np.full(n, 125.0), np.full(n, 400.0),
                          np.full(racks, 125.0 * n / racks / 2)])
    eff[2 * n:] *= rng.choice([1.0, 0.3, 0.05], racks)
    rack = np.arange(n) * racks // n
    links = np.full((k, 4), -1, dtype=np.int32)
    for f in range(k):
        s, d = rng.integers(0, n, 2)
        if s == d:
            links[f, 0] = n + s
        else:
            links[f, :2] = s, d
            if rack[s] != rack[d]:
                links[f, 2:] = 2 * n + rack[s], 2 * n + rack[d]
    return eff, links, links >= 0, eps, nL


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b), np.flatnonzero(a != b)[:8]


def test_torch_bulk_matches_numpy_on_recorded_calls():
    calls = recorded_calls()
    assert len(calls["fills"]) >= 5 and len(calls["prices"]) >= 5
    torch_bulk, ref = TorchBulk("cpu"), NumpyBulk()
    for eff, links, valid, eps in calls["fills"]:
        for got, want in zip(torch_bulk.waterfill(eff, links, valid, eps),
                             ref.waterfill(eff, links, valid, eps)):
            _same(got, want)
    for share, links, valid in calls["prices"]:
        _same(torch_bulk.price(share, links, valid),
              ref.price(share, links, valid))
    assert torch_bulk.n_rounds > torch_bulk.n_calls == len(calls["fills"])


@pytest.mark.parametrize("eps", [0.0, 0.05])
@pytest.mark.parametrize("seed", range(6))
def test_torch_bulk_matches_numpy_on_random_tables(seed, eps):
    rng = np.random.default_rng(seed)
    eff, links, valid, eps, nL = random_table(
        rng, n=int(rng.integers(4, 30)), racks=int(rng.integers(1, 5)),
        k=int(rng.integers(1, 200)), eps=eps)
    torch_bulk, ref = TorchBulk("cpu"), NumpyBulk()
    share, rate = ref.waterfill(eff, links, valid, eps)
    got_share, got_rate = torch_bulk.waterfill(eff, links, valid, eps)
    _same(got_share, share)
    _same(got_rate, rate)
    # Price a batch of the same flows against the solved shares.
    _same(torch_bulk.price(share, links, valid),
          ref.price(share, links, valid))


def test_empty_tables():
    eff = np.array([1.0, 2.0])
    none = np.zeros((0, 4), dtype=np.int32)
    for b in (TorchBulk("cpu"), NumpyBulk()):
        share, rate = b.waterfill(eff, none, none >= 0, 0.05)
        assert np.array_equal(share, eff) and rate.shape == (0,)
        assert b.price(eff, none, none >= 0).shape == (0,)


def _adversarial_price(seed):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    rng = np.random.default_rng(seed)
    return chip_smoke.price_inputs(rng, 64, "cpu")


@pytest.mark.parametrize("seed", range(4))
def test_price_ref_matches_numpy_on_boundary_inputs(seed):
    share, links, valid = _adversarial_price(seed)
    v = valid.numpy()
    want = NumpyBulk().price(share.numpy(), links.numpy(), v)
    got = B.price_ref(share, links, valid).numpy()
    _same(got, want)
    assert np.isinf(got[~v.any(axis=1)]).all(), "pad rows price to +inf"
    assert (got[v.any(axis=1)] >= 1.0).all()
    assert (want == 1.0).any(), "no share below 1.0 decided a row"


def test_price_wrapper_dispatch():
    share, links, valid = _adversarial_price(0)
    before = dict(K.launches)
    assert torch.equal(B.price(share, links, valid),
                       B.price_ref(share, links, valid))
    assert K.launches == before, "a CPU call must not count a launch"
    meta = torch.empty(4, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="devices"):
        B.price(meta, links, valid)


@pytest.mark.parametrize("bad", ["share-dtype", "links-dtype", "valid-shape",
                                 "links-contiguity"])
def test_launch_price_checks_arguments_before_building(bad):
    cap, nL = 16, 10
    args = {"share": torch.zeros(nL, dtype=torch.float64),
            "links": torch.zeros((cap, 4), dtype=torch.int32),
            "valid": torch.zeros((cap, 4), dtype=torch.bool)}
    if bad == "share-dtype":
        args["share"] = args["share"].float()
    elif bad == "links-dtype":
        args["links"] = args["links"].long()
    elif bad == "valid-shape":
        args["valid"] = torch.zeros((cap, 3), dtype=torch.bool)
    else:
        args["links"] = torch.zeros((4, cap), dtype=torch.int32).t()
    with pytest.raises((TypeError, ValueError)):
        K.launch_price(args["share"], args["links"], args["valid"])
    assert not K._libs


# ---------------------------------------------------------------------------
# 4. Against the reference's Pallas pricing kernel and jax water-fill
# ---------------------------------------------------------------------------
def pallas_child(indir, outdir):
    """Child-process body: price and water-fill every saved table on the
    reference's PallasBulk (Pallas kernel in interpret mode, jax
    water-fill) and write the results."""
    from repro.accel.bulk import PallasBulk
    from repro.accel.pallas_backend import INTERPRET
    assert INTERPRET, "the Pallas reference must run in interpret mode"
    bulk = PallasBulk()
    for path in sorted(Path(indir).glob("*.npz")):
        z = np.load(path)
        out = {"price": bulk.price(z["share"], z["links"], z["valid"])}
        if "eff" in z.files:
            out["share"], out["rate"] = bulk.waterfill(
                z["eff"], z["links"], z["valid"], float(z["eps"]))
        np.savez(Path(outdir) / path.name, **out)


_CHILD = """
import sys
import jax
import jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)
sys.path.insert(0, sys.argv[1])
import test_torch_net
test_torch_net.pallas_child(sys.argv[2], sys.argv[3])
"""


def _pallas_tables():
    """Boundary pricing inputs, recorded pricing calls, and random
    water-fill tables (ε 0 and 0.05)."""
    tables = []
    for seed in range(3):
        share, links, valid = _adversarial_price(seed)
        tables.append({"share": share.numpy(), "links": links.numpy(),
                       "valid": valid.numpy()})
    for share, links, valid in recorded_calls()["prices"][:6]:
        tables.append({"share": share, "links": links, "valid": valid})
    for seed in range(4):
        rng = np.random.default_rng(100 + seed)
        eff, links, valid, eps, _nL = random_table(
            rng, k=int(rng.integers(5, 120)), eps=(0.0, 0.05)[seed % 2])
        share, _rate = NumpyBulk().waterfill(eff, links, valid, eps)
        tables.append({"share": share, "links": links, "valid": valid,
                       "eff": eff, "eps": np.float64(eps)})
    return tables


@pytest.fixture(scope="module")
def pallas_results(tmp_path_factory):
    pytest.importorskip("jax")
    indir = tmp_path_factory.mktemp("tables")
    outdir = tmp_path_factory.mktemp("pallas")
    tables = _pallas_tables()
    for i, t in enumerate(tables):
        np.savez(indir / f"t{i:03d}.npz", **t)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    env.setdefault("JAX_PLATFORMS", "cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, str(ROOT / "tests"), str(indir),
         str(outdir)], env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [(t, dict(np.load(outdir / f"t{i:03d}.npz")))
            for i, t in enumerate(tables)]


def test_price_ref_matches_pallas(pallas_results):
    for t, out in pallas_results:
        got = B.price_ref(*(torch.from_numpy(np.ascontiguousarray(t[k]))
                            for k in ("share", "links", "valid")))
        k = len(t["links"])
        # PallasBulk pads to its own power of two and drops the padding.
        _same(got.numpy()[:k], out["price"])


def test_torch_waterfill_matches_jax(pallas_results):
    n = 0
    for t, out in pallas_results:
        if "eff" not in t:
            continue
        share, rate = TorchBulk("cpu").waterfill(
            t["eff"], t["links"], t["valid"], float(t["eps"]))
        _same(share, out["share"])
        _same(rate, out["rate"])
        n += 1
    assert n >= 4


# ---------------------------------------------------------------------------
# 5. On the card (skips without one)
# ---------------------------------------------------------------------------
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(4))
def test_price_kernel_matches_plain_version_on_card(seed):
    _need_card()
    share, links, valid = _adversarial_price(seed)
    before = K.launches["price"]
    got = B.price(share.cuda(), links.cuda(), valid.cuda())
    assert K.launches["price"] == before + 1
    _same(got.cpu().numpy(), B.price_ref(share, links, valid).numpy())


@pytest.mark.cuda
def test_card_bulk_matches_numpy():
    _need_card()
    calls = recorded_calls()
    card, ref = TorchBulk("cuda"), NumpyBulk()
    for eff, links, valid, eps in calls["fills"]:
        for got, want in zip(card.waterfill(eff, links, valid, eps),
                             ref.waterfill(eff, links, valid, eps)):
            _same(got, want)
    for share, links, valid in calls["prices"]:
        _same(card.price(share, links, valid),
              ref.price(share, links, valid))


# ---------------------------------------------------------------------------
# 6. chip_smoke.py's fair scenario, reduced
# ---------------------------------------------------------------------------
def test_chip_smoke_fair_scenario_matches_reference():
    import dataclasses
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    size = dict(n_workers=60, n_jobs=3, gb=6.0, cap=120.0)
    assess, bulk, got = chip_smoke.recording_backends("cpu", at=60.0)
    sim, launches, key, _wall = chip_smoke.fair_scenario(
        assess, bulk, racks=4, **size)
    from repro.sim.mapreduce import BINO_PARAMS
    ref = ref_sim.Simulation(
        policy="bino", seed=0, n_workers=60, n_containers=8,
        assess_backend="numpy", shuffle="kernel", net="fair", racks=4,
        net_opts={"realloc": True},
        params=dataclasses.replace(BINO_PARAMS, sim_time_cap=120.0),
        record_actions=True)
    ref_launches = []
    orig = ref._start_attempt

    def logged(req, node_id):
        ref_launches.append((ref.engine.now, req.task.task_id, node_id,
                             req.reason, req.speculative, req.rollback))
        return orig(req, node_id)

    ref._start_attempt = logged
    jobs = [ref.submit(ref_sim.JobSpec(f"j{i}", "terasort", 6.0,
                                       submit_time=float(i)))
            for i in range(3)]
    ref_sim.faults.crash_busiest_node_at_map_progress(ref, jobs[0], 0.4)
    ref_sim.faults.lose_mof_at_map_progress(ref, jobs[1], 1.0)
    ref_sim.faults.rack_switch_degrade_at(ref, **chip_smoke.DEGRADE)
    results = ref.run()
    ref_key = [(r.job_id, r.finish_time, r.n_attempts, r.n_spec_attempts,
                r.n_fetch_failures) for r in results]
    assert ref.action_trace, "scenario produced no actions — not probing"
    assert_same_run((ref.action_trace, ref_launches, ref_key),
                    (sim.action_trace, launches, key))
    assert sim.shuffle.n_reallocs == ref.shuffle.n_reallocs > 0
    assert bulk.n_prices == len(got["prices"]) > 0
    assert got["now"] >= 60.0 and got["state"]["n"] > 0
