"""The port's ``examples/*_torch.py`` drivers on the CPU.

Each driver runs through its ``main([... "--device", "cpu"])`` in this
process (``chip_smoke.run_example``, which captures its output), and the
reference's driver as a subprocess with ``JAX_PLATFORMS=cpu``. The
runtime drivers, ``train_lm_torch`` and ``serve_torch``, are in
``tests/test_torch_examples_runtime.py``.

1. ``cluster_sim_torch`` against ``examples/cluster_sim.py``, line for
   line with the wall-clock fields masked (``chip_smoke.mask_walls``):
   flat at the defaults, ``--net topo --trace`` (the trace files the same
   bytes), ``--net fair --racks 4``, each assessing on numpy and on
   ``TorchBackend("cpu")``; the predictor column from one checkpoint
   written by the reference's own writer; ``--sweep 8`` against the
   reference's ``BatchedSweep.run_serial`` (its ``--sweep`` needs
   ``enable_x64``, gone from jax 0.9).
2. ``quickstart_torch`` for every architecture.
3. Without ``--device cpu`` on a host with no card, every driver raises.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
DRIVERS = ("cluster_sim", "train_lm", "serve", "quickstart")


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)     # four host threads, a tiny model
    yield
    torch.set_num_threads(n)


def reference(script: str, *args) -> str:
    """``examples/<script>`` of the reference package, run on the CPU;
    its standard output."""
    path = os.pathsep.join(filter(None, [str(ROOT / "src"),
                                         os.environ.get("PYTHONPATH")]))
    env = dict(os.environ, PYTHONPATH=path, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(EXAMPLES / script),
                           *map(str, args)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def port(chip_smoke, name: str, *args) -> str:
    run = chip_smoke.run_example(name, args, "cpu")
    assert run["rc"] == 0, run["out"]
    return run["out"]


# ---------------------------------------------------------------------------
# 1. cluster_sim
# ---------------------------------------------------------------------------
CLUSTER_CASES = {"flat": (), "topo": ("--net", "topo", "--trace"),
                 "fair": ("--net", "fair", "--racks", "4")}


@pytest.fixture(scope="module")
def cluster_ref(tmp_path_factory):
    """The reference's output (and trace) for each case, run once."""
    cache = {}

    def get(case):
        if case not in cache:
            args = list(CLUSTER_CASES[case])
            trace = None
            if "--trace" in args:
                trace = tmp_path_factory.mktemp("ref") / "trace.json"
                args.append(trace)
            cache[case] = (reference("cluster_sim.py", *args), trace)
        return cache[case]
    return get


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("case", sorted(CLUSTER_CASES))
def test_cluster_sim_lines_match_reference(chip_smoke, cluster_ref, case,
                                           backend, tmp_path):
    want, ref_trace = cluster_ref(case)
    args = list(CLUSTER_CASES[case])
    if "--trace" in args:
        args.append(tmp_path / "trace.json")
    got = port(chip_smoke, "cluster_sim", *args, "--assess-backend", backend)
    chip_smoke.same_cluster_lines(f"{case} {backend}", got, want)
    assert ("   torch " in got) == (backend == "torch")
    if ref_trace is not None:
        assert (tmp_path / "trace.json").read_bytes() == \
            ref_trace.read_bytes()
        assert "  scorecard: recall=" in got


@pytest.fixture(scope="module")
def ref_predictor_ckpt(tmp_path_factory):
    """A predictor checkpoint written by the reference's own writer from
    its seeded parameters, with a threshold that nominates backups."""
    from repro.checkpoint.manager import CheckpointManager
    from repro.predict.model import init_params

    out = tmp_path_factory.mktemp("ref_predictor")
    params = {k: np.asarray(v, np.float64)
              for k, v in init_params(0).items()}
    CheckpointManager(str(out), keep=2).save(params, 1,
                                             metadata={"threshold": 0.3})
    return out


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_cluster_sim_predictor_column(chip_smoke, ref_predictor_ckpt,
                                      backend):
    args = ("--policy", "predictor", "--model", ref_predictor_ckpt)
    want = reference("cluster_sim.py", *args)
    got = port(chip_smoke, "cluster_sim", *args, "--assess-backend",
               backend)
    chip_smoke.same_cluster_lines(f"predictor {backend}", got, want)
    assert "--- PREDICTOR ---" in got and "(predict)" in got


def test_cluster_sim_sweep_against_reference_serial(chip_smoke):
    """``--sweep 8``: each scenario's line, from the port's batched step on
    the CPU, is the reference's ``run_serial`` verdict on the same
    snapshot."""
    import dataclasses

    from repro.accel.sweep import BatchedSweep, scenario_grid
    from repro.sim import JobSpec, Simulation
    from repro.sim.mapreduce import SimParams

    got = port(chip_smoke, "cluster_sim", "--sweep", 8, "--assess-backend",
               "numpy")
    lines = got.split("=== batched sweep: 8 fault scenarios, one device "
                      "step ===\n")[1].splitlines()
    sim = Simulation(policy="yarn", seed=1, params=dataclasses.replace(
        SimParams(), sim_time_cap=80.0))
    for j in range(3):
        sim.submit(JobSpec(f"j{j}", "terasort", 2.0,
                           submit_time=float(3 * j)))
    sim.run()
    scenarios = scenario_grid(8, len(sim.cluster.node_ids), seed=1,
                              n_racks=sim.cluster.net.n_racks)
    serial = BatchedSweep(sim.arrays, sim.engine.now).prepare(
        scenarios).run_serial()
    want = [f"  {sc.kind:>12}: spatial_hits={int(v['spatial_hits'].sum())} "
            f"failed_nodes={int(v['failed'].sum())} "
            f"late_victims={int((v['late_victims'] >= 0).sum())} "
            f"reaps={v['n_reap']}" for sc, v in zip(scenarios, serial)]
    assert lines[:8] == want
    assert lines[8].startswith("  serial numpy ")
    assert sum("failed_nodes=1" in line for line in want) >= 1


@pytest.mark.parametrize("backend, device", [("numpy", "cpu"),
                                             ("torch", "cpu")])
def test_cluster_sim_bulk_solver_follows_device(chip_smoke, backend,
                                                device):
    """On the fair network the driver names the bulk solver of its own
    backend and device (``FairNetwork``'s default would be the card);
    the flat and topo networks take none."""
    from repro_torch.accel.bulk import NumpyBulk, TorchBulk
    from repro_torch.sim import Simulation

    mod = chip_smoke.example_module("cluster_sim_torch")
    for net in ("flat", "topo"):
        assert "net_opts" not in mod.backend_kw(backend, device, net)
    kw = mod.backend_kw(backend, device, "fair")
    sim = Simulation(policy="bino", seed=0, net="fair", racks=4, **kw)
    sim.cluster.net.enable_bulk()
    solver = sim.cluster.net._backend
    if backend == "numpy":
        assert isinstance(solver, NumpyBulk)
    else:
        assert isinstance(solver, TorchBulk)
        assert solver.device == torch.device(device)


# ---------------------------------------------------------------------------
# 2. quickstart
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_quickstart_every_architecture(chip_smoke, arch):
    from repro.configs import get_config

    full = get_config(arch)
    total, active = full.param_counts()
    lines = port(chip_smoke, "quickstart", "--arch", arch).splitlines()
    assert lines[0] == (f"[{arch}] family={full.family} "
                        f"params={total/1e9:.2f}B (active {active/1e9:.2f}B)"
                        f"; running the reduced twin on CPU")
    m = re.match(r"^train step: loss=(\S+) grad_norm=(\S+) \([\d.]+s first "
                 r"call\)$", lines[1])
    assert m and np.isfinite(float(m.group(1))) and \
        np.isfinite(float(m.group(2)))
    if full.is_encoder_only():
        assert lines[2:] == ["ok"]
    else:
        assert re.match(r"^decode step: logits \(2, 256\) \([\d.]+s first "
                        r"call\)$", lines[2])
        assert lines[3:] == ["ok"]


def test_quickstart_phase_on_cpu(chip_smoke):
    """The examples phase's quickstart step on the CPU: one architecture
    of each family through the driver, no launch."""
    assert chip_smoke.examples_quickstart("cpu") == {}


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-2.7b",
                                  "hubert-xlarge"])
def test_quickstart_twin_check(chip_smoke, monkeypatch, arch):
    """The card's same-weights check of the quickstart steps, run CPU
    against CPU: every error 0 (the same bits), the decode logits
    compared where the model decodes; a loss 1e-3 off fails it."""
    errs = chip_smoke.quickstart_twin_check(arch, "cpu")
    want = {"loss", "grad_norm"} | (set() if arch == "hubert-xlarge"
                                    else {"logits"})
    assert set(errs) == want and not any(errs.values())
    monkeypatch.setattr(chip_smoke, "quickstart_twin_errors",
                        lambda a, d: {"loss": 1e-3, "grad_norm": 0.0})
    with pytest.raises(RuntimeError, match="relative errors"):
        chip_smoke.quickstart_twin_check(arch, "cpu")


# ---------------------------------------------------------------------------
# 3. No card, no --device cpu: no fallback
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", DRIVERS)
def test_driver_without_card_raises(chip_smoke, name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the driver would run on it")
    mod = chip_smoke.example_module(f"{name}_torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
