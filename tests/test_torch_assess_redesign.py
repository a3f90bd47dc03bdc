"""The algorithms of the redesigned B3 (LATE/collective) and B4 (sibling
reap) kernels, checked on the CPU through plain torch mirrors of them.

The CUDA kernels run only on the card; these mirrors follow their steps
(``src/repro_torch/accel/csrc/assess.cu``) so that the algorithms, not
only the plain versions, meet the references here:

1. **B3's selection** — ``np.percentile``'s two order statistics by an MSD
   radix select over the order-preserving uint64 image of the doubles
   (8-bit digits, stopping once a bucket holds one key), then the second
   statistic from the first, then numpy's ``_lerp``: against
   ``torch.sort`` and ``np.percentile`` on doubles with ties, ±0.0,
   subnormals and infinities, q from 0 to 100.
2. **B3 as a whole** — a row pass that walks each task segment from its
   first row and appends one record per contributing segment (in a
   shuffled order: the kernel's slots come from atomics), then a job pass
   per job slot, with a small shared-memory capacity so that both of the
   kernel's candidate sources run: against ``late_ref`` on the boundary
   inputs of ``chip_smoke.py``, and on the recorded snapshots of
   ``tests/test_torch_assess.py`` against ``NumpyBackend`` and the
   reference's Pallas kernels in interpret mode (its child process).
3. **B4's tiles** — heads numbered by a two-level prefix count (warp
   ballots, then warp totals), per-segment flags, and the walks out of
   the tile's first and last segment: against ``reap_ref`` at several
   tile sizes.
4. **Task segments** — ``check_segments`` on every ``prep`` output of
   the recorded snapshots (the tick path) and of the sweep's kernel
   arguments, and its refusals.
5. **Launchers** — argument checks before anything is built, and the
   wrappers' constants against the CUDA source.
6. **On the card** (marked ``cuda``; they skip without one) — the
   kernels on the boundary inputs: twice with the same bits, equal to the
   plain versions, and with a scenario axis equal to one call per
   scenario; B3's work buffer reused and its counters left at zero.
"""
import math
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.accel import kernels as K
from repro_torch.accel import torch_backend as TB
from repro_torch.accel.torch_backend import TorchBackend
from repro_torch.core.arrays import snapshot_from_state
from test_torch_assess import (assert_same, call, expected,  # noqa: F401
                               pallas_results, recorded)
from test_torch_sweep import SNAPSHOTS, _port_sweep

ROOT = Path(__file__).resolve().parents[1]
MIN64 = -(1 << 63)
MAX64 = (1 << 63) - 1


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def _s64(v: int) -> int:
    """A 64-bit pattern as the signed int torch.int64 holds."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


# ---------------------------------------------------------------------------
# Mirror of B3's selection (int64 tensors hold the uint64 images' bits)
# ---------------------------------------------------------------------------
def order_keys(x: torch.Tensor) -> torch.Tensor:
    """The kernel's ``order_key``: unsigned order of the images equals the
    numeric order of the doubles, -0.0 below +0.0."""
    b = x.to(torch.float64).view(torch.int64)
    return torch.where(b < 0, ~b, b | MIN64)


def key_values(k: torch.Tensor) -> torch.Tensor:
    return torch.where(k < 0, k & MAX64, ~k).view(torch.float64)


def _unsigned(k: torch.Tensor) -> torch.Tensor:
    """Images re-biased so that signed comparison is unsigned order."""
    return k ^ MIN64


def radix_select(keys: torch.Tensor, k: int) -> int:
    """The kernel's ``radix_select``: the k-th smallest image, 8 bits a
    pass from the top, each pass histogramming the keys that match the
    digits chosen so far; a bucket of one key ends the search."""
    prefix = 0
    for shift in range(56, -1, -8):
        hi_mask = 0 if shift == 56 else _s64(-1 << (shift + 8))
        match = keys[(keys & hi_mask) == prefix]
        hist = torch.bincount((match >> shift) & 255, minlength=256)
        incl = torch.cumsum(hist, 0)
        bucket = int(torch.searchsorted(incl, k, right=True))
        k -= int(incl[bucket] - hist[bucket])
        prefix = _s64(prefix | (bucket << shift))
        if int(hist[bucket]) == 1 and shift > 0:
            mask = _s64(-1 << shift)
            (found,) = keys[(keys & mask) == prefix].tolist()
            return found
    return prefix


def next_key(keys: torch.Tensor, a: int, rank: int) -> int:
    """The kernel's ``next_key``: the image at ``rank`` given the image
    ``a`` at ``rank - 1``."""
    u, ua = _unsigned(keys), a ^ MIN64
    if rank < int((u <= ua).sum()):
        return a
    return int(u[u > ua].min()) ^ MIN64


def percentile_select(rho: torch.Tensor, q: float):
    """(a, b, thresh) as the kernel's job pass computes them."""
    m = rho.numel()
    v = (m - 1) * (q / 100.0)
    flo = math.floor(v)
    gamma = v - flo
    loi = min(max(int(flo), 0), m - 1)
    hii = min(loi + 1, m - 1)
    keys = order_keys(rho)
    ka = radix_select(keys, loi)
    kb = ka if hii == loi else next_key(keys, ka, hii)
    a, b = (float(key_values(torch.tensor([x]))[0]) for x in (ka, kb))
    diff = b - a
    thresh = b - diff * (1.0 - gamma) if gamma >= 0.5 else a + diff * gamma
    return a, b, thresh, loi, hii


SPECIAL = [0.0, -0.0, 5e-324, -5e-324, 2.2250738585072014e-308, 1e-310,
           math.inf, -math.inf, 1.0, -1.0, 1e300, -1e-300]


def _sample(rng, m: int, finite: bool = False) -> np.ndarray:
    special = [x for x in SPECIAL if not finite or math.isfinite(x)]
    pool = np.concatenate([special, rng.choice([0.1, 0.25, 0.5], 4),
                           rng.normal(0, 1e3, 8), rng.random(8) * 1e-6])
    return rng.choice(pool, m)


@pytest.mark.parametrize("seed", range(6))
def test_radix_select_matches_sort(seed):
    rng = np.random.default_rng(seed)
    for m in list(range(1, 20)) + [64, 257, 1500]:
        x = torch.from_numpy(_sample(rng, m))
        srt = torch.sort(x).values
        keys = order_keys(x)
        # the images sort as the doubles do, and map back bit for bit
        assert torch.equal(key_values(keys).view(torch.int64),
                           x.view(torch.int64))
        img = torch.sort(_unsigned(keys)).values ^ MIN64
        assert torch.equal(key_values(img), srt)      # ±0.0 compare equal
        for k in {0, m // 3, m // 2, m - 1}:
            got = radix_select(keys, k)
            assert got == int(img[k]), (m, k)
            if k + 1 < m:
                assert next_key(keys, got, k + 1) == int(img[k + 1])


@pytest.mark.parametrize("seed", range(6))
def test_percentile_select_matches_numpy(seed):
    rng = np.random.default_rng(100 + seed)
    qs = (0.0, 10.0, 25.0, 50.0, 75.0, 90.0, 100.0, float(rng.random() * 100))
    for m in list(range(2, 24)) + [101, 1100]:
        # finite, as rho is on every path of the port; ties, ±0.0 and
        # subnormals included
        x = _sample(rng, m, finite=True)
        rho = torch.from_numpy(x)
        srt = torch.sort(rho).values
        for q in qs:
            a, b, thresh, loi, hii = percentile_select(rho, q)
            # order statistics: the sorted values (the sign of a zero may
            # differ, which only a comparison reads)
            assert a == float(srt[loi]) and b == float(srt[hii])
            want = float(np.percentile(x, q))
            assert thresh == want or (math.isnan(thresh)
                                      and math.isnan(want)), (m, q)
            assert torch.equal(rho < thresh, rho < want)


def test_percentile_select_with_infinities_matches_numpy():
    x = np.array([-math.inf, 0.5, 0.5, math.inf, 2.0])
    for q in (0.0, 25.0, 50.0, 100.0):
        got = percentile_select(torch.from_numpy(x), q)[2]
        with np.errstate(invalid="ignore"):
            want = float(np.percentile(x, q))
        assert got == want or (math.isnan(got) and math.isnan(want)), q


# ---------------------------------------------------------------------------
# Mirror of B3 as a whole
# ---------------------------------------------------------------------------
def _np_max(x: float, c: float) -> float:
    return x if (math.isnan(x) or x > c) else c


def late_row_pass(prog, start, rate, spec, tseg, jls, running, runatt,
                  now, min_runtime, win_factor):
    """The kernel's row pass: records (job, nrun, win, cand, rho, est,
    pos) of the segments that contribute, in row order."""
    cap = len(tseg)
    out = []
    for i in range(cap):
        if i > 0 and tseg[i - 1] == tseg[i]:
            continue
        s = tseg[i]
        bprog, bstart, bpos, hspec, nrun = -math.inf, 0.0, -1, 0, 0
        hi = lo = -math.inf
        has_spec = has_orig = 0
        r = i
        while r < cap and tseg[r] == s:
            sp = spec[r]
            if running[r] == 1:
                nrun += 1
                if prog[r] > bprog:
                    bprog, bpos, bstart = prog[r], r, start[r]
                hspec |= sp
            if runatt[r] == 1:
                if sp:
                    hi = hi if math.isnan(hi) else _np_max(rate[r], hi)
                    has_spec = 1
                else:
                    lo = lo if math.isnan(lo) else _np_max(rate[r], lo)
                    has_orig = 1
            r += 1
        win = bool(has_spec and (not has_orig or hi > lo * win_factor))
        cand = bpos >= 0 and not hspec and (now - bstart >= min_runtime)
        rho = est = 0.0
        if cand:
            rho = bprog / _np_max(now - bstart, 1e-9)
            est = (1.0 - bprog) / _np_max(rho, 1e-9)
        if nrun or win or cand:
            out.append((int(jls[i]), nrun, win, cand, rho, est, bpos))
    return out


def late_job_pass(records, order, q: float, jcap: int, cands: int):
    """The kernel's job pass over the records (in any order). A job with
    at most ``cands`` candidates selects over its gathered copy, one with
    more over the whole list with its candidates picked out on each read
    (the kernel's global source): the same function of the same set."""
    victim, win = [], []
    for j in range(jcap):
        mine = [r for r in records if r[0] == j]
        nrows = sum(r[1] for r in mine)
        win.append(int(any(r[2] for r in mine)))
        got = [r for r in mine if r[3]]
        m = len(got)
        if nrows < 2 or m < 2:
            victim.append(-1)
            continue
        src = got if m <= cands else [r for r in records
                                      if r[0] == j and r[3]]
        rho = torch.tensor([r[4] for r in src], dtype=torch.float64)
        _a, _b, thresh, _l, _h = percentile_select(rho, q)
        best = (-math.inf, 2 ** 31 - 1)
        for r in src:
            if r[4] < thresh and (r[5] > best[0] or (r[5] == best[0]
                                                     and r[6] < best[1])):
                best = (r[5], r[6])
        victim.append(-1 if best[1] == 2 ** 31 - 1 else int(order[best[1]]))
    return victim, win


def late_mirror(prog, start, rate, spec, tseg, jls, running, runatt, order,
                now, min_runtime, q, win_factor, jcap, *,
                cands: int = K.LATE_SMEM_CANDS, seed: int = 0):
    """B3 by the kernel's algorithm: (victim, win) as ``late_ref``."""
    if prog.dim() == 2:
        outs = [late_mirror(*(t[i] for t in (prog, start, rate, spec, tseg,
                                             jls, running, runatt, order)),
                            now, min_runtime, q, win_factor, jcap,
                            cands=cands, seed=seed + i)
                for i in range(prog.shape[0])]
        return tuple(torch.stack(o) for o in zip(*outs))
    cols = [t.tolist() for t in (prog, start, rate, spec, tseg, jls, running,
                                 runatt)]
    records = late_row_pass(*cols, now, min_runtime, win_factor)
    perm = np.random.default_rng(seed).permutation(len(records))
    records = [records[k] for k in perm]       # the slots' order is free
    victim, win = late_job_pass(records, order.tolist(), q, jcap, cands)
    i32 = torch.int32
    return torch.tensor(victim, dtype=i32), torch.tensor(win, dtype=i32)


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("case", _chip_smoke().BOUNDARY_CASES)
def test_late_mirror_matches_plain_on_boundary_cases(case):
    args = _chip_smoke().boundary_inputs(case, 0, "cpu")["late"]
    want = TB.late_ref(*args)
    _same(late_mirror(*args), want)
    # a capacity of 2 sends every job past it: the global source
    _same(late_mirror(*args, cands=2, seed=1), want)
    if case == "many_cands":
        tseg, jls, running = args[4], args[5], args[6]
        cand_tasks = torch.unique(tseg[(jls == 1) & (running == 1)]).numel()
        assert cand_tasks > K.LATE_SMEM_CANDS


@pytest.mark.parametrize("seed", range(3))
def test_late_mirror_matches_plain_on_adversarial_inputs(seed):
    args = _chip_smoke().adversarial_inputs(seed, "cpu")["late"]
    want = TB.late_ref(*args)
    _same(late_mirror(*args, seed=seed), want)
    _same(late_mirror(*args, cands=8, seed=seed + 1), want)


def test_late_mirror_with_scenario_axis():
    cs = _chip_smoke()
    args = cs.stack_scenarios("late", [
        cs.boundary_inputs("interleaved", s, "cpu")["late"]
        for s in range(3)])
    _same(late_mirror(*args), TB.late_ref(*args))


# ---------------------------------------------------------------------------
# Mirror of B4
# ---------------------------------------------------------------------------
def reap_mirror(a_state, tseg, live, tile: int = K.REAP_TILE):
    """B4 by the kernel's algorithm: tiles of ``tile`` rows; heads
    numbered by warp ballots and the warps' exclusive prefix; a flag per
    segment of the tile; walks out of its first and last segment."""
    if a_state.dim() == 2:
        return torch.stack([reap_mirror(a_state[i], tseg[i], live[i], tile)
                            for i in range(a_state.shape[0])])
    cap = a_state.shape[0]
    ts, st, lv = tseg.tolist(), a_state.tolist(), live.tolist()

    def done(r):
        return lv[r] == 1 and st[r] == 1 and 0 <= ts[r] < cap

    out = torch.zeros(cap, dtype=torch.int32)
    for base in range(0, cap, tile):
        end = min(base + tile, cap)
        rows = range(base, end)
        head = [i == 0 or ts[i - 1] != ts[i] for i in rows]
        # per warp of 32 rows: its head count, then the exclusive prefix
        warps = [head[w:w + 32] for w in range(0, tile, 32)]
        totals = [sum(w) for w in warps]
        warp_base = [sum(totals[:k]) for k in range(len(warps))]
        ids = [warp_base[k // 32] + sum(warps[k // 32][:k % 32 + 1])
               for k in range(end - base)]
        flag = [0] * (tile + 1)
        for k, i in enumerate(rows):
            if done(i):
                flag[ids[k]] = 1
        if not head[0]:                       # the segment carried in
            r = base - 1
            while r >= 0 and ts[r] == ts[base]:
                if done(r):
                    flag[0] = 1
                    break
                r -= 1
        if end < cap and ts[end] == ts[end - 1]:   # into the next tile
            r = end
            while r < cap and ts[r] == ts[end - 1]:
                if done(r):
                    flag[ids[-1]] = 1
                    break
                r += 1
        for k, i in enumerate(rows):
            out[i] = int(lv[i] == 1 and st[i] == 0 and 0 <= ts[i] < cap
                         and flag[ids[k]] == 1)
    return out


@pytest.mark.parametrize("case", _chip_smoke().BOUNDARY_CASES)
def test_reap_mirror_matches_plain_on_boundary_cases(case):
    args = _chip_smoke().boundary_inputs(case, 0, "cpu")["reap"]
    want = TB.reap_ref(*args)
    for tile in (K.REAP_TILE, 64, 32):
        assert torch.equal(reap_mirror(*args, tile=tile), want), tile


def test_reap_boundary_cases_cross_tile_edges():
    cs = _chip_smoke()
    for case in ("tile_edge", "whole_tile"):
        a_state, tseg, live = cs.boundary_inputs(case, 0, "cpu")["reap"]
        out = TB.reap_ref(a_state, tseg, live)
        ts = tseg.long()
        edges = torch.arange(K.REAP_TILE, tseg.numel(), K.REAP_TILE)
        crossing = ts[edges] == ts[edges - 1]
        assert crossing.any(), case
        for e in edges[crossing].tolist():
            seg = ts == ts[e]
            done = int((seg & (live == 1) & (a_state == 1)).sum())
            reaped = torch.nonzero(seg & (out == 1)).flatten()
            if done:                          # siblings reaped both sides
                assert reaped.min() < e <= reaped.max(), (case, e)
            else:
                assert not reaped.numel(), (case, e)
    # a segment covering the whole tile [1024, 2048)
    a_state, tseg, live = cs.boundary_inputs("whole_tile", 0, "cpu")["reap"]
    assert int(torch.unique(tseg[K.REAP_TILE:2 * K.REAP_TILE]).numel()) == 1


@pytest.mark.parametrize("seed", range(4))
def test_reap_mirror_matches_plain_on_random_segments(seed):
    cs = _chip_smoke()
    rng = np.random.default_rng(seed)
    for cap in (1, 31, 32, 33, 100, 257):
        tseg = cs._runs(rng, cap, (1, 9)).astype(np.int32)
        if seed % 2:                  # whole runs of out-of-range ids
            bad = rng.random(int(tseg[-1]) + 1) < 0.2
            tseg = np.where(bad[tseg], np.where(tseg % 2, -1, cap + 3),
                            tseg).astype(np.int32)
        a_state = rng.choice(4, cap, p=[0.5, 0.3, 0.1, 0.1]).astype(np.int32)
        live = (rng.random(cap) < 0.7).astype(np.int32)
        args = tuple(torch.from_numpy(x) for x in (a_state, tseg, live))
        ok = torch.tensor([0 <= t < cap for t in tseg.tolist()])
        lv, st, ts = args[2] == 1, args[0], args[1].long()
        done = torch.zeros(cap + 1, dtype=torch.bool)
        done[torch.where(ok, ts, cap)[lv & (st == 1) & ok]] = True
        want = (lv & (st == 0) & ok & done[torch.where(ok, ts, cap)]).to(
            torch.int32)
        if ok.all():
            assert torch.equal(want, TB.reap_ref(*args))
        for tile in (32, 64, 1024):
            assert torch.equal(reap_mirror(*args, tile=tile), want), (cap,
                                                                      tile)


def test_reap_mirror_with_scenario_axis():
    cs = _chip_smoke()
    args = cs.stack_scenarios("reap", [
        cs.boundary_inputs("tile_edge", s, "cpu")["reap"] for s in range(3)])
    assert torch.equal(reap_mirror(*args), TB.reap_ref(*args))


# ---------------------------------------------------------------------------
# The mirrors on the recorded snapshots: NumpyBackend and Pallas
# ---------------------------------------------------------------------------
MIRRORED = ("late_victims", "winning", "reap_rows")


@pytest.fixture
def mirrored(monkeypatch):
    """``TorchBackend("cpu")`` with B3 and B4 replaced by the mirrors."""
    def late(*args):
        return late_mirror(*args, cands=4)
    monkeypatch.setattr(TB, "late", late)
    monkeypatch.setattr(TB, "reap", lambda *a: reap_mirror(*a, tile=32))


def _mirror_result(rec):
    arr = snapshot_from_state(rec["state"])
    return call(TorchBackend("cpu"), arr, rec["method"], rec["now"],
                rec["args"])


@pytest.mark.parametrize("method", MIRRORED)
def test_mirrors_match_numpy_records(method, mirrored):
    n = 0
    for recs in recorded().values():
        for rec in recs:
            if rec["method"] == method:
                assert_same(method, _mirror_result(rec), expected(rec),
                            rec["args"])
                n += 1
    assert n >= 5


@pytest.mark.parametrize("method", MIRRORED)
def test_mirrors_match_pallas(method, pallas_results, mirrored):
    n = 0
    for rec, pallas in pallas_results:
        if rec["method"] == method:
            assert_same(method, _mirror_result(rec), pallas, rec["args"])
            n += 1
    assert n >= 5


# ---------------------------------------------------------------------------
# Task segments
# ---------------------------------------------------------------------------
def test_prep_segments_contiguous_on_recorded_snapshots():
    n = 0
    for recs in recorded().values():
        for rec in recs:
            if rec["state"] is None:
                continue
            arr = snapshot_from_state(rec["state"])
            p, _jcap = TorchBackend("cpu")._prep(arr, rec["now"],
                                                 arr.active_jobs())
            TB.check_segments(p["tseg32"], p["jls32"])
            n += 1
    assert n >= 20


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_sweep_segments_contiguous(name):
    args, _cols = _port_sweep(name).kernel_args("cpu")
    TB.check_segments(args["late"][4], args["late"][5])
    assert torch.equal(args["reap"][1], args["late"][4])


def test_check_segments_refuses_broken_runs():
    i32 = torch.int32
    TB.check_segments(torch.tensor([0, 0, 1, 5, 5, 6], dtype=i32),
                      torch.tensor([2, 2, 0, 1, 1, 0], dtype=i32))
    with pytest.raises(ValueError, match="contiguous"):
        TB.check_segments(torch.tensor([0, 1, 0], dtype=i32),
                          torch.zeros(3, dtype=i32))
    with pytest.raises(ValueError, match="job"):
        TB.check_segments(torch.tensor([[0, 0, 1], [0, 0, 1]], dtype=i32),
                          torch.tensor([[1, 1, 2], [1, 3, 2]], dtype=i32))


# ---------------------------------------------------------------------------
# Launchers
# ---------------------------------------------------------------------------
def _late_args(cap=8, N=None, f64=torch.float64, jcap=4):
    shape = (cap,) if N is None else (N, cap)
    f = [torch.zeros(shape, dtype=f64) for _ in range(3)]
    i = [torch.zeros(shape, dtype=torch.int32) for _ in range(6)]
    return (*f, *i, 100.0, 10.0, 25.0, 1.0, jcap)


@pytest.mark.parametrize("bad", ["dtype", "jcap", "empty", "scenarios",
                                 "mixed"])
def test_late_launcher_checks_arguments_before_building(bad):
    args = {"dtype": _late_args(f64=torch.float32),
            "jcap": _late_args(jcap=0),
            "empty": _late_args(cap=0),
            "scenarios": _late_args(N=0),
            "mixed": _late_args()[:8] + (torch.zeros(9, dtype=torch.int32),)
            + _late_args()[9:]}[bad]
    with pytest.raises((TypeError, ValueError)):
        K.launch_late(*args)
    assert not K._libs and not K._late_work


def test_reap_launcher_refuses_empty_rows():
    z = torch.zeros(0, dtype=torch.int32)
    with pytest.raises(ValueError, match="no rows"):
        K.launch_reap(z, z, z)
    assert not K._libs


def test_wrapper_constants_match_the_source():
    src = (Path(K.SOURCES["assess"])).read_text()
    defs = {k: v.strip() for k, v in
            re.findall(r"^#define (\w+) (.+)$", src, flags=re.M)}
    assert int(defs["NTHREADS"]) == K.LATE_ROWS
    assert defs["LATE_ROWS"] == "NTHREADS"
    assert int(defs["LATE_SMEM_CANDS"]) == K.LATE_SMEM_CANDS
    assert int(defs["REAP_TILE"]) == K.REAP_TILE
    assert defs["LATE_WIN_BIT"] == "(1 << 29)" and K.LATE_MAX_CAP == 1 << 29
    assert {"late_jobs", "late_sweep_jobs"} <= set(K.launches)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")


@pytest.mark.cuda
@pytest.mark.parametrize("case", _chip_smoke().BOUNDARY_CASES)
def test_boundary_cases_on_card(case):
    _need_card()
    cs = _chip_smoke()
    fns = {"late": (TB.late, TB.late_ref), "reap": (TB.reap, TB.reap_ref)}
    for name, (wrapper, plain) in fns.items():
        dev = cs.boundary_inputs(case, 0, "cuda")[name]
        want = plain(*cs.boundary_inputs(case, 0, "cpu")[name])
        keys = [name] + (["late_jobs"] if name == "late" else [])
        before = [K.launches[k] for k in keys]
        got = wrapper(*dev)
        assert [K.launches[k] for k in keys] == [b + 1 for b in before]
        assert cs._compare(got, wrapper(*dev))[0], (name, case)
        _same(tuple(o.cpu() for o in cs._as_tuple(got)), cs._as_tuple(want))
        dev4 = cs.stack_scenarios(name, [cs.boundary_inputs(case, s, "cuda")
                                         [name] for s in range(4)])
        batched = cs._as_tuple(wrapper(*dev4))
        for s in range(4):
            one = cs._as_tuple(wrapper(*cs.one_scenario(name, dev4, s)))
            _same(tuple(b[s] for b in batched), one)


@pytest.mark.cuda
def test_late_work_buffer_reused_and_reset_on_card():
    _need_card()
    cs = _chip_smoke()
    args = cs.boundary_inputs("interleaved", 0, "cuda")["late"]
    first = TB.late(*args)
    second = TB.late(*args)
    torch.cuda.synchronize()
    assert cs._compare(first, second)[0]
    keys = [k for k in K._late_work if k[2:] == (1, args[0].shape[0])]
    assert len(keys) == 1
    counters = K._late_work[keys[0]][-2 * 4:].view(torch.int32)
    assert int(counters.abs().sum()) == 0      # left at 0 for the next call
