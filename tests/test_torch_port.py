"""The torch port stands alone, and its snapshot layer matches the
reference package.

1. **Stands alone** — ``repro_torch`` imports with jax made unimportable
   and loads no module of the reference package; no file of the port,
   not ``chip_smoke.py`` and not the ``examples/*_torch.py`` drivers
   imports either, and each driver imports with jax made unimportable;
   ``chip_smoke.py`` refuses to run
   without a card or outside a checkout.
2. **Registry** — ``get_backend(None)`` and ``get_bulk_backend(None)``
   are torch on the card and raise without one; ``"numpy"`` and
   ``"torch"`` on the CPU resolve; ``make_network`` builds every network
   model.
3. **Mirror** — the ``DeviceColumns`` padding/compaction cases of
   ``tests/test_accel.py``, run on the port's snapshot, and the
   ``snapshot_state``/``snapshot_from_state`` round trip from a reference
   snapshot.
"""
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.sim import JobSpec as RefJobSpec
from repro.sim import Simulation as RefSimulation
from repro_torch.accel import BACKENDS, get_backend
from repro_torch.accel.base import AssessmentBackend
from repro_torch.accel.bulk import (
    BULK_BACKENDS,
    NumpyBulk,
    TorchBulk,
    get_bulk_backend,
)
from repro_torch.core.arrays import (
    ArraySnapshot,
    DeviceColumns,
    snapshot_from_state,
    snapshot_state,
)
from repro_torch.core.types import AttemptState, TaskKind, TaskState
from repro_torch.net import FairNetwork, FlatNetwork, TopoNetwork, \
    make_network
from repro_torch.sim import Simulation

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


# ---------------------------------------------------------------------------
# 1. Stands alone
# ---------------------------------------------------------------------------
_ALONE = """
import sys
sys.modules["jax"] = None
import repro_torch.sim
import repro_torch.sim.runner
import repro_torch.sim.workload
import repro_torch.net
import repro_torch.accel.torch_backend
import repro_torch.accel.kernels
import repro_torch.accel.bulk
import repro_torch.accel.sweep
import repro_torch.configs
import repro_torch.kernels.flash_attention.ops
import repro_torch.kernels.decode_attention.ops
import repro_torch.kernels.ssd.ops
import repro_torch.models.mamba2
import repro_torch.models.moe
import repro_torch.models.inputs
import repro_torch.models
import repro_torch.models.convert
import repro_torch.train.loop
import repro_torch.optim
import repro_torch.data
import repro_torch.checkpoint
import repro_torch.obs.metrics
import repro_torch.obs.export
import repro_torch.obs.scorecard
import repro_torch.predict.features
import repro_torch.predict.model
import repro_torch.predict.policy
import repro_torch.predict.dataset
import repro_torch.predict.train
import repro_torch.runtime
ref = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not ref, ref
assert "jax" not in [m for m, v in sys.modules.items() if v is not None]
print("alone")
"""


def test_port_imports_without_jax_or_reference():
    proc = subprocess.run([sys.executable, "-c", _ALONE],
                          cwd=ROOT / "src", capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "alone"


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:\.|\s|$)", re.M)


EXAMPLES = sorted(p.relative_to(ROOT)
                  for p in (ROOT / "examples").glob("*_torch.py"))


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT) for p in PORT.rglob("*.py")]
    + [Path("chip_smoke.py")] + EXAMPLES), ids=str)
def test_no_jax_or_reference_import(path):
    text = (ROOT / path).read_text()
    assert not _IMPORT.findall(text), path


_DRIVER_ALONE = """
import sys
sys.modules["jax"] = None
sys.path.insert(0, "../examples")
import {name}
ref = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not ref, ref
assert "jax" not in [m for m, v in sys.modules.items() if v is not None]
print("alone")
"""


@pytest.mark.parametrize("path", EXAMPLES, ids=str)
def test_example_imports_without_jax_or_reference(path):
    """Each ``examples/*_torch.py`` driver imports with jax made
    unimportable and loads no module of the reference package."""
    proc = subprocess.run(
        [sys.executable, "-c", _DRIVER_ALONE.format(name=path.stem)],
        cwd=ROOT / "src", capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "alone"


def _smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_refuses_without_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run")
    proc = _smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_refuses_outside_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


# ---------------------------------------------------------------------------
# 2. Registry
# ---------------------------------------------------------------------------
def test_default_backend_is_the_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_backend(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_backend("torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Simulation(policy="bino")


def test_backend_registry():
    assert BACKENDS == ("numpy", "torch")
    b = get_backend("numpy")
    assert isinstance(b, AssessmentBackend) and b.name == "numpy"
    t = get_backend("torch", device="cpu")
    assert t.name == "torch" and t.device.type == "cpu"
    assert get_backend(t) is t
    with pytest.raises(ValueError):
        get_backend("pallas")


@pytest.mark.parametrize("spec,racks,cls,n_racks", [
    ("flat", 0, FlatNetwork, 1), ("topo", 0, TopoNetwork, 4),
    ("topo", 3, TopoNetwork, 3), ("fair", 0, FairNetwork, 1),
    ("fair", 40, FairNetwork, 40)])
def test_make_network_builds_every_model(spec, racks, cls, n_racks):
    net = make_network(spec, racks=racks)
    assert type(net) is cls and net.n_racks == n_racks
    assert make_network(net) is net
    sim = Simulation(policy="yarn", assess_backend="numpy", net=spec,
                     racks=racks)
    assert type(sim.cluster.net) is cls
    assert len(sim.arrays.rack_factor) == n_racks


def test_fair_network_defaults_to_the_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert FairNetwork()._bulk_backend_spec is None
    # Only the kernel engine arms the bulk solver; it needs the card.
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Simulation(policy="yarn", assess_backend="numpy", net="fair",
                   shuffle="kernel")
    sim = Simulation(policy="yarn", assess_backend="numpy", net="fair",
                     shuffle="kernel", net_opts={"bulk_backend": "numpy"})
    assert isinstance(sim.cluster.net._backend, NumpyBulk)


def test_bulk_registry(monkeypatch):
    import torch
    assert BULK_BACKENDS == ("numpy", "torch")
    assert isinstance(get_bulk_backend("numpy"), NumpyBulk)
    t = TorchBulk("cpu")
    assert t.name == "torch" and t.device.type == "cpu"
    assert get_bulk_backend(t) is t
    with pytest.raises(ValueError):
        get_bulk_backend("pallas")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (TorchBulk, lambda: get_bulk_backend(None),
                 lambda: get_bulk_backend("torch")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# ---------------------------------------------------------------------------
# 3. DeviceColumns mirror (tests/test_accel.py's cases on the port)
# ---------------------------------------------------------------------------
def _check_mirror(arr: ArraySnapshot, dc: DeviceColumns):
    host = dc.refresh(arr.active_jobs())
    n = arr.n
    assert dc.cap >= max(n, 1)
    assert dc.cap & (dc.cap - 1) == 0, "capacity must stay a power of two"
    for name, fill in DeviceColumns._FILLS.items():
        buf = host[name]
        assert len(buf) == dc.cap
        assert np.array_equal(buf[:n], getattr(arr, name)[:n])
        pad = buf[n:]
        expect = np.full(dc.cap - n, fill, dtype=pad.dtype)
        assert np.array_equal(pad, expect), name
    assert np.array_equal(host["order"][:n], arr.order())
    assert not host["order"][n:].any()
    assert host["n_rows"] == n


def _snapshot_ops(arr: ArraySnapshot, ops, rng):
    """Replay an op script against a raw snapshot (no simulator)."""
    jidx = arr.job_started("j0")
    owners = []
    for op in ops:
        if op == 0 or not owners:   # add a row
            o = type("O", (), {"row": -1})()
            t_order = len(owners) // 2
            if t_order * 2 == len(owners):   # first attempt of a task
                arr.task_created(jidx)
            o.row = arr.add_attempt(
                o, f"a{len(owners)}", f"t{t_order}", t_order,
                len(owners) % 2, jidx, int(rng.integers(0, 4)),
                TaskKind.MAP if t_order % 2 else TaskKind.REDUCE,
                bool(rng.integers(0, 2)), float(rng.random()),
                0.0, 1.0 + float(rng.random()), 3, TaskState.RUNNING)
            owners.append(o)
        elif op == 1:               # progress sync
            o = owners[int(rng.integers(0, len(owners)))]
            arr.sync_row(o.row, float(rng.random()), float(rng.random()))
        elif op == 2:               # end an attempt
            o = owners[int(rng.integers(0, len(owners)))]
            arr.set_attempt_state(o.row, AttemptState.COMPLETED)
        elif op == 3:               # deactivate everything (job done)...
            arr.job_finished("j0")
            arr.job_started("j0")   # ...and reopen for later adds
        else:                       # force physical compaction
            arr._compact()
    return arr


@pytest.mark.parametrize("seed", [7, 11, 23])
def test_device_columns_mirror_seeded(seed):
    rng = np.random.default_rng(seed)
    arr = ArraySnapshot([f"n{i:02d}" for i in range(4)])
    dc = DeviceColumns(arr)
    ops = list(rng.integers(0, 5, size=400))
    caps = []
    for cut in range(0, len(ops), 23):
        _snapshot_ops(arr, ops[cut:cut + 23], rng)
        _check_mirror(arr, dc)
        caps.append(dc.cap)
    assert caps == sorted(caps), "capacity must never shrink"


def test_device_columns_repad_after_compaction():
    # Rows vacated by compaction must return to exact pad fills.
    arr = ArraySnapshot(["n00", "n01"])
    rng = np.random.default_rng(0)
    _snapshot_ops(arr, [0] * 60, rng)       # 60 live rows
    dc = DeviceColumns(arr)
    _check_mirror(arr, dc)
    arr.job_finished("j0")                  # all rows dead
    arr._compact()
    arr.job_started("j0")
    _check_mirror(arr, dc)
    assert arr.n == 0


def test_snapshot_state_round_trip(tmp_path):
    # A mid-run reference snapshot, through an .npz file, into the port.
    sim = RefSimulation(policy="bino", seed=3, assess_backend="numpy")
    sim.submit(RefJobSpec("j0", "terasort", 2.0))
    sim.submit(RefJobSpec("j1", "terasort", 1.0, submit_time=5.0))
    sim.engine.run(until=60.0)
    ref = sim.arrays
    assert ref.n > 0 and ref._scratch
    np.savez(tmp_path / "s.npz", **snapshot_state(ref))
    port = snapshot_from_state(np.load(tmp_path / "s.npz"))
    assert port.n == ref.n
    assert port.node_ids == ref.node_ids
    assert port.active_jobs() == ref.active_jobs()
    assert port.attempt_ids == ref.attempt_ids
    for name in ref._float_cols + ref._int_like_cols:
        got, want = getattr(port, name), getattr(ref, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    for name, (col, fill) in ref._scratch.items():
        pcol, pfill = port._scratch[name]
        assert np.array_equal(pcol, col, equal_nan=True), name
        assert pfill == fill or (np.isnan(pfill) and np.isnan(fill))
    assert np.array_equal(port.order(), ref.order())
    assert np.array_equal(port.running_rows(), ref.running_rows())
