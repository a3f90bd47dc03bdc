"""The reference's pinned fault corpus, port against reference.

``tests/test_fuzz_equivalence.py`` runs its corpus across the shuffle
engines and dispatcher configurations of the reference alone. Here every
cell of it runs through both packages: the reference assessing on numpy,
the port on numpy and on ``TorchBackend("cpu")`` (B1–B4's plain
versions). Action traces, attempt launches and job results must be
byte-identical, engine by engine (``assert_same_run``):

1. ``PINNED`` × the four engines, with the reference's mid-run invariant
   sweeps on the batch and kernel engines;
2. the probe test on the port: the reference's threshold, and each
   script's verdict (did it bend the run?) equal to the reference's;
3. the batch lane's record-at-a-time drain against the fused one on
   ``PINNED``, on the batch and kernel engines;
4. the multi-job matrix (three jobs, four engines);
5. ``DISPATCH_VARIANTS`` × ``PINNED`` on the batch and kernel engines;
6. the multi-job bulk/scalar dispatch cell.

The corpus is imported from the reference's test module, which stays as
it is. ``PINNED_NET`` is in ``tests/test_torch_fuzz_net.py``, the random
scripts in ``tests/test_torch_fuzz_random.py``; both use this file's
``port_vs_reference``.
"""
import pytest

import repro.sim as ref_sim
import repro_torch.sim as port_sim
from repro_torch.accel.torch_backend import TorchBackend
from test_fuzz_equivalence import DISPATCH_VARIANTS, PINNED
from test_torch_sim import assert_same_run, run_traced

SHUFFLES = ("rescan", "event", "batch", "kernel")
CHECKS = range(20, 700, 45)     # the reference's mid-run sweeps
PORT_BACKENDS = ("numpy", "torch-cpu")
PINNED_IDS = [p[0] for p in PINNED]


def script_fault(script):
    def fault(pkg, sim, job):
        pkg.faults.apply_script(sim, job, script)
    return fault


def port_backend(name):
    return TorchBackend("cpu") if name == "torch-cpu" else name


def port_vs_reference(script, *, policy, seed, mode, **kw):
    """The reference on numpy, then the port on each of
    ``PORT_BACKENDS``, under the same script; each port run must be the
    reference's byte for byte. Returns the reference's run."""
    fault = script_fault(script) if script is not None else None
    ref = run_traced(ref_sim, policy, fault, seed=seed, mode=mode,
                     assess_backend="numpy", **kw)
    for backend in PORT_BACKENDS:
        port = run_traced(port_sim, policy, fault, seed=seed, mode=mode,
                          assess_backend=port_backend(backend), **kw)
        try:
            assert_same_run(ref, port)
        except AssertionError as e:
            raise AssertionError(f"{mode}, port on {backend}: {e}") from None
    return ref


def sweeps(mode):
    """Mid-run invariant sweeps where the reference's matrix runs them."""
    return CHECKS if mode in ("batch", "kernel") else None


# ---------------------------------------------------------------------------
# 1. PINNED x four engines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", SHUFFLES)
@pytest.mark.parametrize("name,policy,seed,script", PINNED, ids=PINNED_IDS)
def test_pinned_matches_reference(name, policy, seed, script, mode):
    ref = port_vs_reference(script, policy=policy, seed=seed, mode=mode,
                            gb=1.0, checks=sweeps(mode))
    assert ref[1], "scenario launched nothing — not probing"


# ---------------------------------------------------------------------------
# 2. The probe test, on the port
# ---------------------------------------------------------------------------
def reasoned(launches):
    """Launches with a reason: re-runs and speculative copies."""
    return sum(1 for launch in launches if launch[3])


def _pinned_probed(pkg, backend):
    """The reference's ``test_pinned_scripts_probe_faults`` verdict of
    each script: re-runs, speculative copies or fetch failures."""
    out = []
    for name, policy, seed, script in PINNED:
        _trace, launches, key = run_traced(
            pkg, policy, script_fault(script), seed=seed, gb=1.0,
            assess_backend=backend)
        # a result key: (job, finish, attempts, spec attempts, fetch fails)
        fetch_fail = sum(k[4] for k in key)
        spec = sum(k[3] for k in key)
        out.append(bool(reasoned(launches) or fetch_fail or spec))
    return out


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_pinned_scripts_probe_faults(backend):
    got = _pinned_probed(port_sim, port_backend(backend))
    assert got == _pinned_probed(ref_sim, "numpy")
    assert sum(got) >= len(PINNED) // 2, got


# ---------------------------------------------------------------------------
# 3. Batch generic-drain parity on PINNED
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["batch", "kernel"])
@pytest.mark.parametrize("name,policy,seed,script", PINNED, ids=PINNED_IDS)
def test_generic_drain_parity_matches_reference(name, policy, seed, script,
                                                mode):
    """The port's record-at-a-time drain gives the reference's run and
    the port's fused drain's."""
    fused = run_traced(port_sim, policy, script_fault(script), seed=seed,
                       gb=1.0, mode=mode, assess_backend="numpy")
    generic = port_vs_reference(script, policy=policy, seed=seed,
                                mode=mode, gb=1.0, generic_drain=True)
    assert_same_run(generic, fused)


# ---------------------------------------------------------------------------
# 4. The multi-job matrix
# ---------------------------------------------------------------------------
# The reference's inline cells: extra jobs as (job_id, bench, GB, submit
# time), under one crash.
MULTI_SCRIPT = [("crash", 6, 0.3, 0.0)]
MULTI_JOB = (("j1", "wordcount", 0.5, 25.0), ("j2", "grep", 0.5, 40.0))


@pytest.mark.parametrize("mode", SHUFFLES)
def test_multi_job_matrix_matches_reference(mode):
    ref = port_vs_reference(MULTI_SCRIPT, policy="bino", seed=4, mode=mode,
                            gb=1.0, extra_jobs=MULTI_JOB)
    assert len(ref[2]) == 3


# ---------------------------------------------------------------------------
# 5. The dispatch column
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["batch", "kernel"])
@pytest.mark.parametrize("name,policy,seed,script", PINNED, ids=PINNED_IDS)
def test_dispatch_variants_match_reference(name, policy, seed, script,
                                           mode):
    """Each dispatcher configuration, port against reference; on one job
    every configuration gives the same run (the reference's §19 gate)."""
    runs = [port_vs_reference(script, policy=policy, seed=seed, mode=mode,
                              gb=1.0, dispatch_opts=opts)
            for _label, opts in DISPATCH_VARIANTS]
    for run in runs[1:]:
        assert_same_run(runs[0], run)


MULTI_TENANT = (("j1", "wordcount", 0.5, 6.0), ("j2", "grep", 1.0, 8.0),
                ("j3", "terasort", 0.5, 9.0))


@pytest.mark.parametrize("mode", ["batch", "kernel"])
def test_multi_job_bulk_scalar_dispatch_matches_reference(mode):
    runs = [port_vs_reference(MULTI_SCRIPT, policy="bino", seed=4,
                              mode=mode, gb=1.0, extra_jobs=MULTI_TENANT,
                              dispatch_opts=opts)
            for opts in ({"bulk": True, "bulk_min": 1}, {"bulk": False})]
    assert_same_run(runs[0], runs[1])
    assert len(runs[0][2]) == 4
