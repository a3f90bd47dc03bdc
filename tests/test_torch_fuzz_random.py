"""Random fault scripts through both packages.

The strategies are the reference's own (``_script``: crash, restore,
slowdown, heartbeat outage, MOF loss and disk exception on the flat
network; ``_net_script``: rack degrade, link cut, partition, crash, slow
and MOF loss), imported from ``tests/test_fuzz_equivalence.py`` at its
budget (``REPRO_FUZZ_EXAMPLES``, 8 by default). Every drawn script runs
through the reference on numpy and the port on numpy and on
``TorchBackend("cpu")``: traces, attempt launches and results must be
byte-identical, for

1. the four shuffle engines on the flat network;
2. the four engines on the 4-rack topo network, 6 GB jobs;
3. every dispatcher configuration on the batch engine;
4. the batch lane's record-at-a-time drain (and the port's fused drain);
5. the batch engine with the reference's dense invariant sweeps;
6. the kernel engine on the ε-fair network: staged bulk tables (numpy, and
   ``TorchBulk("cpu")`` with the torch backend), scalar accounting and
   the record-at-a-time drain.

The draws are derandomized: the same scripts on every run, so that the
suite's time is fixed. A random draw can wedge a job until the
simulator's 36,000 s cap (yarn, seed 6, ``[("cut", 6, 0.281, 0.281)]``
on the topo network: 36,000 assessment ticks, about 65 s a run on
``TorchBackend("cpu")``, in the reference as in the port); a larger
``REPRO_FUZZ_EXAMPLES`` widens the search. Without hypothesis the
module is skipped, as the reference's random tests are.
"""
import pytest

import repro.sim as ref_sim
import repro_torch.sim as port_sim
from conftest import HAVE_HYPOTHESIS, check_invariants
from repro_torch.accel.bulk import TorchBulk
from test_fuzz_equivalence import (_FUZZ_EXAMPLES, DISPATCH_VARIANTS,
                                   FAIR_RACKS, NET_GB)
from test_torch_fuzz import (PORT_BACKENDS, SHUFFLES, port_backend,
                             port_vs_reference, script_fault)
from test_torch_sim import assert_same_run, run_traced

if not HAVE_HYPOTHESIS:
    pytest.skip("hypothesis not installed", allow_module_level=True)

from hypothesis import example, given, settings, strategies as st  # noqa: E402

from test_fuzz_equivalence import _net_script, _script  # noqa: E402

HALF = max(_FUZZ_EXAMPLES // 2, 4)     # the reference's smaller budgets


@given(script=_script, seed=st.integers(0, 7),
       policy=st.sampled_from(["yarn", "bino"]))
@settings(max_examples=_FUZZ_EXAMPLES, deadline=None, derandomize=True)
@example(script=[("mof", 0, 0.9, 1.0), ("crash", 3, 0.4, 0.0)], seed=2,
         policy="bino")
@example(script=[("disk", 0, 0.0, 1.0), ("crash_restore", 1, 0.3, 0.5)],
         seed=1, policy="yarn")
def test_random_scripts_match_reference(script, seed, policy):
    for mode in SHUFFLES:
        port_vs_reference(script, policy=policy, seed=seed, mode=mode,
                          gb=1.0)


@given(script=_net_script, seed=st.integers(0, 7),
       policy=st.sampled_from(["yarn", "bino"]))
@settings(max_examples=_FUZZ_EXAMPLES, deadline=None, derandomize=True)
@example(script=[("degrade", 0, 0.2, 0.1), ("cut", 3, 0.4, 0.5)], seed=3,
         policy="bino")
@example(script=[("part", 1, 0.3, 0.6), ("mof", 0, 0.9, 1.0)], seed=1,
         policy="yarn")
def test_random_net_scripts_match_reference(script, seed, policy):
    for mode in SHUFFLES:
        port_vs_reference(script, policy=policy, seed=seed, mode=mode,
                          gb=NET_GB, net="topo", racks=4)


@given(script=_script, seed=st.integers(0, 7))
@settings(max_examples=HALF, deadline=None, derandomize=True)
@example(script=[("mof", 0, 0.9, 1.0), ("crash", 3, 0.4, 0.0)], seed=2)
def test_random_dispatch_matches_reference(script, seed):
    runs = [port_vs_reference(script, policy="bino", seed=seed,
                              mode="batch", gb=1.0, dispatch_opts=opts)
            for _label, opts in DISPATCH_VARIANTS]
    for run in runs[1:]:
        assert_same_run(runs[0], run)


@given(script=_script, seed=st.integers(0, 7))
@settings(max_examples=HALF, deadline=None, derandomize=True)
def test_random_generic_drain_matches_reference(script, seed):
    generic = port_vs_reference(script, policy="bino", seed=seed,
                                mode="batch", gb=1.0, generic_drain=True)
    fused = run_traced(port_sim, "bino", script_fault(script), seed=seed,
                       gb=1.0, assess_backend="numpy")
    assert_same_run(generic, fused)


@given(script=_script, seed=st.integers(0, 5))
@settings(max_examples=HALF, deadline=None, derandomize=True)
def test_random_invariant_sweeps_match_reference(script, seed):
    sims = []
    fault = script_fault(script)
    ref = run_traced(ref_sim, "bino", fault, seed=seed, gb=1.0,
                     assess_backend="numpy", checks=range(5, 900, 13))
    for backend in PORT_BACKENDS:
        port = run_traced(port_sim, "bino", fault, seed=seed, gb=1.0,
                          assess_backend=port_backend(backend),
                          checks=range(5, 900, 13), sim_out=sims)
        assert_same_run(ref, port)
    for sim in sims:
        check_invariants(sim)


FAIR_VARIANTS = (("bulk/fused", {}, False), ("scalar/fused", {"bulk": False},
                                             False),
                 ("bulk/generic", {}, True))


def _fair(pkg, policy, seed, script, backend, opts, generic):
    """One run of the kernel engine on the ε-fair network, 4 racks, the
    reference's mid-run sweeps on every run."""
    return run_traced(pkg, policy, script_fault(script), seed=seed,
                      gb=NET_GB, mode="kernel", assess_backend=backend,
                      net="fair", racks=FAIR_RACKS, net_opts=opts,
                      generic_drain=generic, checks=range(20, 700, 45))


@given(script=_net_script, seed=st.integers(0, 5),
       policy=st.sampled_from(["yarn", "bino"]))
@settings(max_examples=HALF, deadline=None, derandomize=True)
@example(script=[("slow", 4, 0.3, 0.2), ("hb", 9, 0.25, 0.8)], seed=2,
         policy="bino")
def test_random_fair_kernel_matches_reference(script, seed, policy):
    runs = []
    for label, opts, generic in FAIR_VARIANTS:
        ref = _fair(ref_sim, policy, seed, script, "numpy", opts, generic)
        for backend in PORT_BACKENDS:
            bulk = "numpy" if backend == "numpy" else TorchBulk("cpu")
            port = _fair(port_sim, policy, seed, script,
                         port_backend(backend),
                         dict(opts, bulk_backend=bulk), generic)
            try:
                assert_same_run(ref, port)
            except AssertionError as e:
                raise AssertionError(f"{label}, port on {backend}: "
                                     f"{e}") from None
        runs.append(ref)
    for run in runs[1:]:
        assert_same_run(runs[0], run)
