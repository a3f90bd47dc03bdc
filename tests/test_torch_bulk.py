"""The ε-fair bulk solver's water-fill kernel and B5's transfers.

1. ``waterfill_ref`` (the water-fill kernel's plain version: the eager
   torch rounds) against ``NumpyBulk.waterfill`` bit for bit, rounds
   included, on ``chip_smoke.py``'s boundary cases (no flows, one link
   for every flow, exact ties and ties within ε, a zero-capacity link,
   flags off the leading slots, a table past shared memory) at ε 0 and
   0.05.
2. A numpy mirror of the kernel's steps (``csrc/bulk.cu``: integer link
   counts, the frozen-link hit test, each share written once, the round
   cap and the bad-id check) against ``NumpyBulk`` on the same cases and
   random tables.
3. ``TorchBulk("cpu", check_reuse=True)``: the solved shares kept for the
   pricing call that follows, their bytes compared on every reuse, over
   the ``PINNED_FAIR`` corpus with re-pricing, against the reference; a
   share array changed after its solve raises.
4. The wrapper's argument checks (before anything is built) and the
   dispatch on CPU tensors; ``chip_smoke.py``'s recording of the solves.
5. On the card (marked ``cuda``; they skip without one): the kernel
   against numpy on random tables, the boundary cases (one past shared
   memory) and a NaN capacity; ``TorchBulk("cuda")`` against numpy.
"""
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
from test_fuzz_equivalence import PINNED_FAIR
from test_torch_net import _fair, random_table, recorded_calls
from test_torch_sim import assert_same_run

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b), np.flatnonzero(a != b)[:8]


def _numpy(eff, links, valid, eps):
    """NumpyBulk's (share, rate) and its round count."""
    ref = NumpyBulk()
    share, rate = ref.waterfill(eff, links, valid, eps)
    return share, rate, ref.n_rounds


def _tensors(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in arrays)


# ---------------------------------------------------------------------------
# 1. The plain version against numpy on the boundary cases
# ---------------------------------------------------------------------------
CASES = ["no_flows", "one_link", "ties", "ties_eps", "zero_cap", "slots",
         "past_smem"]


@pytest.mark.parametrize("eps", [0.0, 0.05])
@pytest.mark.parametrize("case", CASES)
def test_waterfill_ref_matches_numpy_on_boundary_cases(chip_smoke, case,
                                                       eps):
    assert tuple(CASES) == chip_smoke.WATERFILL_CASES
    eff, links, valid = chip_smoke.waterfill_inputs(case, 0)
    share, rate, rounds = _numpy(eff, links, valid, eps)
    got = B.waterfill_ref(*_tensors(eff, links.astype(np.int32), valid),
                          eps)
    _same(got[0].numpy(), share)
    _same(got[1].numpy(), rate)
    assert got[2] == rounds
    if case == "no_flows":
        assert rounds == 0 and np.array_equal(share, eff)
    elif case == "one_link":
        assert rounds == 1
    else:
        assert rounds > 1
    if case == "past_smem":
        assert 13 * len(eff) + len(links) > K.MAX_SMEM


def test_boundary_cases_probe_what_they_name(chip_smoke):
    ties = chip_smoke.waterfill_inputs("ties", 0)
    near = chip_smoke.waterfill_inputs("ties_eps", 0)
    # ε merges near-ties: fewer rounds at 0.05 than at 0
    assert _numpy(*ties, 0.05)[2] < _numpy(*ties, 0.0)[2]
    assert _numpy(*near, 0.05)[2] < _numpy(*near, 0.0)[2]
    eff, links, valid = chip_smoke.waterfill_inputs("zero_cap", 0)
    share, rate, _r = _numpy(eff, links, valid, 0.0)
    assert rate[0] == 0.0 and (share[eff == 0.0] == 0.0).all()
    eff, links, valid = chip_smoke.waterfill_inputs("slots", 0)
    assert (~valid[:, 0]).any() and (links[~valid] >= len(eff)).any()


# ---------------------------------------------------------------------------
# 2. A mirror of the kernel's steps
# ---------------------------------------------------------------------------
def kernel_mirror(eff, links, valid, eps):
    """The water-fill kernel's algorithm in numpy, step for step:
    ``(share, rate, rounds, status)``."""
    nL, k = len(eff), len(links)
    if (valid & ((links < 0) | (links >= nL))).any():
        return None, None, 0, 2
    rem = eff.copy()
    cnt = np.zeros(nL, dtype=np.int64)
    frozen = np.zeros(nL, dtype=bool)
    share = np.full(nL, np.nan)
    rate = np.zeros(k)
    alive = valid.any(axis=1)
    eps1 = 1.0 + eps
    rounds, status = 0, 0
    while True:
        for i in np.flatnonzero(alive):                 # 1. counts
            np.add.at(cnt, links[i][valid[i]], 1)
        if not alive.any():
            break
        if rounds == k + 1:
            status = 1
            break
        rounds += 1
        counted = cnt > 0                               # 2. the minimum
        s = np.inf
        for x in rem[counted] / cnt[counted]:
            s = x if np.isnan(x) or (not np.isnan(s) and x < s) else s
        thr = s * eps1
        for l in np.flatnonzero(counted):               # 3. bottlenecks
            if rem[l] / cnt[l] <= thr:
                frozen[l] = True
                share[l] = s
        cnt[:] = 0
        for i in np.flatnonzero(alive):                 # 4. hit flows
            ids = links[i][valid[i]]
            if frozen[ids].any():
                rate[i] = s
                alive[i] = False
                np.add.at(cnt, ids, 1)
        dec = cnt.astype(np.float64) * s                # 5. remainders
        x = rem - dec
        rem = np.where(np.isnan(x) | (x > 0.0), x, 0.0)
        cnt[:] = 0
    share[~frozen] = rem[~frozen]
    return share, rate, rounds, status


@pytest.mark.parametrize("eps", [0.0, 0.05])
@pytest.mark.parametrize("case", [c for c in CASES if c != "past_smem"])
def test_kernel_mirror_matches_numpy_on_boundary_cases(chip_smoke, case,
                                                       eps):
    eff, links, valid = chip_smoke.waterfill_inputs(case, 1)
    share, rate, rounds, status = kernel_mirror(eff, links, valid, eps)
    want = _numpy(eff, links, valid, eps)
    assert status == 0
    _same(share, want[0])
    _same(rate, want[1])
    assert rounds == want[2]


@pytest.mark.parametrize("eps", [0.0, 0.05])
@pytest.mark.parametrize("seed", range(6))
def test_kernel_mirror_matches_numpy_on_random_tables(seed, eps):
    rng = np.random.default_rng(300 + seed)
    eff, links, valid, eps, _nL = random_table(
        rng, n=int(rng.integers(4, 30)), racks=int(rng.integers(1, 5)),
        k=int(rng.integers(1, 200)), eps=eps)
    share, rate, rounds, status = kernel_mirror(eff, links, valid, eps)
    want = _numpy(eff, links, valid, eps)
    assert status == 0
    _same(share, want[0])
    _same(rate, want[1])
    assert rounds == want[2]


def test_kernel_mirror_stops_on_nan_and_bad_ids():
    eff, links, valid, _eps, _nL = random_table(np.random.default_rng(2))
    eff[links[0, 0]] = np.nan            # a counted link: no progress
    assert kernel_mirror(eff, links, valid, 0.05)[2:] == (len(links) + 1, 1)
    bad = np.where(valid, links + len(eff), links)
    assert kernel_mirror(eff, bad, valid, 0.05)[2:] == (0, 2)


# ---------------------------------------------------------------------------
# 3. The solved shares kept for the pricing call that follows
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,policy,seed,script", PINNED_FAIR,
                         ids=[p[0] for p in PINNED_FAIR])
def test_share_reuse_keeps_the_bytes_over_pinned_fair(name, policy, seed,
                                                      script):
    ref = _fair(ref_sim, policy, seed, script, "numpy", None, True)
    bulk = TorchBulk("cpu", check_reuse=True)
    port = _fair(port_sim, policy, seed, script, TorchBackend("cpu"), bulk,
                 True)
    assert_same_run(ref, port)
    assert bulk.n_reads == bulk.n_calls > 0
    assert bulk.n_rounds >= bulk.n_calls
    assert 0 < bulk.n_reused <= bulk.n_prices


def test_share_reuse_raises_on_a_changed_share():
    eff, links, valid, eps = recorded_calls()["fills"][0]
    bulk = TorchBulk("cpu", check_reuse=True)
    share, _rate = bulk.waterfill(eff, links, valid, eps)
    want = NumpyBulk().price(share, links, valid)
    _same(bulk.price(share, links, valid), want)
    assert bulk.n_reused == 1
    _same(bulk.price(share.copy(), links, valid), want)   # uploaded
    assert bulk.n_reused == 1
    share[links[0, 0]] += 1.0
    with pytest.raises(RuntimeError, match="stale"):
        bulk.price(share, links, valid)


def test_torch_bulk_counts_rounds_and_reads():
    calls = recorded_calls()
    bulk, ref = TorchBulk("cpu"), NumpyBulk()
    for eff, links, valid, eps in calls["fills"]:
        for got, want in zip(bulk.waterfill(eff, links, valid, eps),
                             ref.waterfill(eff, links, valid, eps)):
            _same(got, want)
    assert bulk.n_calls == ref.n_calls == bulk.n_reads
    assert bulk.n_rounds == ref.n_rounds > bulk.n_calls


# ---------------------------------------------------------------------------
# 4. Wrapper checks, dispatch, chip_smoke's records
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bad", ["eff-dtype", "links-dtype", "valid-dtype",
                                 "valid-shape", "links-contiguity",
                                 "eff-shape"])
def test_launch_waterfill_checks_arguments_before_building(bad):
    k, nL = 16, 10
    args = {"eff": torch.zeros(nL, dtype=torch.float64),
            "links": torch.zeros((k, 4), dtype=torch.int32),
            "valid": torch.zeros((k, 4), dtype=torch.bool)}
    if bad == "eff-dtype":
        args["eff"] = args["eff"].float()
    elif bad == "links-dtype":
        args["links"] = args["links"].long()
    elif bad == "valid-dtype":
        args["valid"] = args["valid"].to(torch.uint8)
    elif bad == "valid-shape":
        args["valid"] = torch.zeros((k, 3), dtype=torch.bool)
    elif bad == "eff-shape":
        args["eff"] = torch.zeros((nL, 1), dtype=torch.float64)
    else:
        args["links"] = torch.zeros((4, k), dtype=torch.int32).t()
    with pytest.raises((TypeError, ValueError)):
        K.launch_waterfill(args["eff"], args["links"], args["valid"], 0.05)
    assert not K._libs


def test_waterfill_wrapper_dispatch():
    eff, links, valid, eps, _nL = random_table(np.random.default_rng(7))
    args = _tensors(eff, links, valid)
    before = dict(K.launches)
    got = B.waterfill(*args, eps)
    want = B.waterfill_ref(*args, eps)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2] == want[2] > 0
    assert K.launches == before, "a CPU call must not count a launch"
    meta = torch.empty(len(eff), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="devices"):
        B.waterfill(meta, *args[1:], eps)


def test_waterfill_views_split_the_result_buffer():
    nL, k = 5, 3
    out = torch.zeros(8 + 8 * (nL + k), dtype=torch.uint8)
    info, share, rate = K.waterfill_views(out, nL, k)
    info[0], info[1] = 7, 0
    share[:] = torch.arange(nL, dtype=torch.float64)
    rate[:] = -1.0
    raw = out.numpy()
    assert raw[:8].view(np.int32).tolist() == [7, 0]
    _same(raw[8:8 + 8 * nL].view(np.float64), np.arange(nL, dtype=float))
    _same(raw[8 + 8 * nL:].view(np.float64), np.full(k, -1.0))


def test_chip_smoke_records_every_solve(chip_smoke):
    assess, bulk, got = chip_smoke.recording_backends("cpu", at=60.0)
    chip_smoke.fair_scenario(assess, bulk, racks=4, n_workers=60, n_jobs=3,
                             gb=6.0, cap=120.0)
    assert len(got["fills"]) == bulk.n_calls == bulk.n_reads > 0
    assert len(got["prices"]) == bulk.n_prices > 0
    ref = NumpyBulk()
    for eff, links, valid, eps in got["fills"]:
        ref.waterfill(eff, links, valid, eps)
    assert ref.n_rounds == bulk.n_rounds
    eff, links, valid, eps = max(got["fills"], key=lambda f: len(f[1]))
    assert chip_smoke._waterfill_ops(eff, links, valid, eps) > 0


# ---------------------------------------------------------------------------
# 5. On the card (skips without one)
# ---------------------------------------------------------------------------
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")


def _card_fill(eff, links, valid, eps):
    """The kernel's (share, rate, rounds) on the card, one launch."""
    dev = tuple(t.cuda() for t in _tensors(eff, links.astype(np.int32),
                                            valid))
    before = K.launches["waterfill"]
    share, rate, rounds = B.waterfill(*dev, eps)
    assert K.launches["waterfill"] == before + 1
    return share.cpu().numpy(), rate.cpu().numpy(), rounds


@pytest.mark.cuda
@pytest.mark.parametrize("eps", [0.0, 0.05])
@pytest.mark.parametrize("seed", range(4))
def test_waterfill_kernel_matches_numpy_on_random_tables(seed, eps):
    _need_card()
    rng = np.random.default_rng(500 + seed)
    eff, links, valid, eps, _nL = random_table(
        rng, n=int(rng.integers(4, 300)), racks=int(rng.integers(1, 9)),
        k=int(rng.integers(1, 3000)), eps=eps)
    got, want = _card_fill(eff, links, valid, eps), _numpy(eff, links,
                                                           valid, eps)
    _same(got[0], want[0])
    _same(got[1], want[1])
    assert got[2] == want[2]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_waterfill_kernel_matches_numpy_on_boundary_cases(chip_smoke, case):
    _need_card()
    eff, links, valid = chip_smoke.waterfill_inputs(case, 3)
    for eps in (0.0, 0.05):
        got, want = _card_fill(eff, links, valid, eps), _numpy(
            eff, links, valid, eps)
        _same(got[0], want[0])
        _same(got[1], want[1])
        assert got[2] == want[2]
    work = K.library("bulk").bulk_waterfill_work_bytes(len(links), len(eff))
    assert (work > 0) == (case == "past_smem")


@pytest.mark.cuda
def test_waterfill_kernel_raises_on_nan_and_bad_ids(chip_smoke):
    _need_card()
    eff, links, valid = chip_smoke.waterfill_inputs("zero_cap", 2)
    eff = eff.copy()
    eff[links[0, 0]] = np.nan
    with pytest.raises(RuntimeError, match="no progress"):
        _card_fill(eff, links, valid, 0.05)
    eff[links[0, 0]] = 1.0
    with pytest.raises(RuntimeError, match="link id"):
        _card_fill(eff, np.where(valid, links + len(eff), links), valid,
                   0.05)


@pytest.mark.cuda
def test_card_torch_bulk_matches_numpy_with_share_reuse():
    _need_card()
    calls = recorded_calls()
    card, ref = TorchBulk("cuda", check_reuse=True), NumpyBulk()
    for eff, links, valid, eps in calls["fills"]:
        got = card.waterfill(eff, links, valid, eps)
        want = ref.waterfill(eff, links, valid, eps)
        _same(got[0], want[0])
        _same(got[1], want[1])
        _same(card.price(got[0], links, valid),
              ref.price(want[0], links, valid))
    for share, links, valid in calls["prices"]:
        _same(card.price(share, links, valid),
              ref.price(share, links, valid))
    assert card.n_reused == card.n_calls == card.n_reads
    assert card.n_rounds == ref.n_rounds
