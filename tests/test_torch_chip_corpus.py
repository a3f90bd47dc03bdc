"""``chip_smoke.py``'s corpus phase, on the CPU.

The script keeps its own copy of the reference's pinned fault corpus
(it imports nothing of ``tests/``): each copy must equal the reference
test module's. Its harness (``corpus_run``) must instrument a run as the
reference's does: on numpy it gives the reference's traces, attempt
launches and results for the last run of every group. ``corpus_phase``
runs on ``TorchBackend("cpu")`` and ``TorchBulk("cpu")`` (the plain
versions) against numpy at the reference's sizes, requires every group to
reach B1–B4 (bino), B3 (yarn) and the solver (fair), and raises on a run
that differs.
"""
import sys
from pathlib import Path

import pytest
import torch

import repro.sim as ref_sim
import test_fuzz_equivalence as F
import test_torch_fuzz as TF
from test_torch_fuzz import script_fault
from test_torch_sim import assert_same_run, run_traced

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


@pytest.mark.parametrize("name", ["PINNED", "PINNED_NET", "NET_GB",
                                  "PINNED_FAIR", "FAIR_RACKS",
                                  "DISPATCH_VARIANTS"])
def test_corpus_copy_equals_reference(chip_smoke, name):
    assert getattr(chip_smoke, name) == getattr(F, name)


def test_multi_job_cells_equal_the_port_tests(chip_smoke):
    """The multi-job cells are written inline in the reference's tests;
    ``tests/test_torch_fuzz.py`` holds its copy against the reference."""
    assert chip_smoke.MULTI_JOB == TF.MULTI_JOB
    assert chip_smoke.MULTI_TENANT == TF.MULTI_TENANT
    assert chip_smoke.MULTI_SCRIPT == TF.MULTI_SCRIPT


def test_corpus_groups_cover_the_corpus(chip_smoke):
    groups = dict(chip_smoke.corpus_groups())
    for mode in chip_smoke.CORPUS_SHUFFLES:
        assert [r[0] for r in groups[f"pinned/{mode}"]] == \
            [p[0] for p in F.PINNED]
        for net in ("flat", "topo"):
            assert [r[0] for r in groups[f"pinned_net/{net}/{mode}"]] == \
                [p[0] for p in F.PINNED_NET]
    for mode in ("batch", "kernel"):
        for label, opts in F.DISPATCH_VARIANTS[1:]:
            runs = groups[f"dispatch/{mode}/{label}"]
            assert [r[4]["dispatch_opts"] for r in runs] == \
                [opts] * len(F.PINNED)
    assert len(groups["multi_job"]) == 8
    assert len(groups["fair"]) == 2 * len(F.PINNED_FAIR)


def _ref_run(policy, seed, script, *, mode, gb, net="flat", racks=0,
             realloc=False, dispatch_opts=None, extra_jobs=()):
    return run_traced(ref_sim, policy, script_fault(script), seed=seed,
                      gb=gb, mode=mode, assess_backend="numpy", net=net,
                      racks=racks, extra_jobs=extra_jobs,
                      net_opts={"realloc": realloc} if net == "fair" else
                      None, dispatch_opts=dispatch_opts)


def test_corpus_run_is_the_reference_harness(chip_smoke):
    for group, runs in chip_smoke.corpus_groups():
        _label, policy, seed, script, kw = runs[-1]
        port = chip_smoke.corpus_run(policy, seed, script, "numpy", "numpy",
                                     **kw)
        ref = _ref_run(policy, seed, script, **kw)
        assert ref[1], group
        assert_same_run(ref, port)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_corpus_phase_on_cpu(chip_smoke, one_thread, capsys):
    only = ["pinned/kernel", "pinned_net/topo/batch", "dispatch/batch/scalar",
            "multi_job", "fair"]
    total = chip_smoke.corpus_phase("cpu", only=only)
    out = capsys.readouterr().out
    for group in only:
        assert f"corpus {group}: " in out
    assert all(total[k] > 0 for k in chip_smoke.CORPUS_KEYS), total


def test_corpus_phase_raises_on_a_divergent_run(chip_smoke, one_thread,
                                                monkeypatch):
    """Every node flagged by the spatial glance on the torch side only:
    the phase must name the run whose trace differs."""
    from repro_torch.accel import torch_backend as TB

    def everyone(*args):
        return torch.ones_like(TB.spatial_ref(*args))

    monkeypatch.setattr(TB, "spatial", everyone)
    with pytest.raises(RuntimeError, match="differ, cpu against numpy"):
        chip_smoke.corpus_phase("cpu", only=["pinned/batch"])
