"""The reference's network-fault corpus, port against reference.

``PINNED_NET`` of ``tests/test_fuzz_equivalence.py`` (rack-switch
degradation, link cuts, whole-rack partitions, alone and with the classic
primitives; 6 GB jobs so that the maps spill across racks) on the flat
and on the 4-rack topo network, under each of the four shuffle engines:
the port on numpy and on ``TorchBackend("cpu")`` gives the reference's
traces, attempt launches and results byte for byte, with the reference's
mid-run invariant sweeps on the batch and kernel engines. Then the
reference's probe test on the port: its threshold, and each script's
verdict equal to the reference's.
"""
import pytest

import repro.sim as ref_sim
import repro_torch.sim as port_sim
from test_fuzz_equivalence import NET_GB, PINNED_NET
from test_torch_fuzz import (PORT_BACKENDS, SHUFFLES, port_backend,
                             port_vs_reference, reasoned, script_fault,
                             sweeps)
from test_torch_sim import run_traced

NET_IDS = [p[0] for p in PINNED_NET]


@pytest.mark.parametrize("mode", SHUFFLES)
@pytest.mark.parametrize("net,racks", [("flat", 0), ("topo", 4)],
                         ids=["flat", "topo4"])
@pytest.mark.parametrize("name,policy,seed,script", PINNED_NET,
                         ids=NET_IDS)
def test_pinned_net_matches_reference(name, policy, seed, script, net,
                                      racks, mode):
    ref = port_vs_reference(script, policy=policy, seed=seed, mode=mode,
                            gb=NET_GB, net=net, racks=racks,
                            checks=sweeps(mode))
    assert ref[1], "scenario launched nothing — not probing"


def _net_probed(pkg, backend):
    """The reference's ``test_pinned_net_scripts_probe_faults`` verdict of
    each script on the 4-rack topology: a JCT shift of more than 1 s
    against the fault-free run, fetch failures, or recovery launches."""
    out = []
    for name, policy, seed, script in PINNED_NET:
        kw = dict(seed=seed, gb=NET_GB, net="topo", racks=4,
                  assess_backend=backend)
        _t, _l, base = run_traced(pkg, policy, None, **kw)
        _t, launches, key = run_traced(pkg, policy, script_fault(script),
                                       **kw)
        # a result key: (job, finish, attempts, spec attempts, fetch fails)
        jct_shift = abs(key[0][1] - base[0][1]) > 1.0
        fetch_fail = sum(k[4] for k in key)
        out.append(bool(jct_shift or reasoned(launches) or fetch_fail))
    return out


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_pinned_net_scripts_probe_faults(backend):
    got = _net_probed(port_sim, port_backend(backend))
    assert got == _net_probed(ref_sim, "numpy")
    assert sum(got) >= (2 * len(PINNED_NET)) // 3, got
