"""The algorithms of the redesigned glance kernels B1 (Eq. 1 spatial pass)
and B2 (Eq. 2–3 ζ sums), checked on the CPU through plain torch mirrors
of them.

The CUDA kernels run only on the card; these mirrors follow their steps
(``src/repro_torch/accel/csrc/assess.cu``, "B1 — Eq. 1 spatial pass, and
B2") so that the algorithms, not only the plain versions, meet the
references here:

1. **Row pass** — rows in tiles of ``GLANCE_ROWS``; a used row's group
   ((job, phase) for B1, the job for B2) and node; each warp of 32 rows
   matches its lanes by group, and the warps, in row order, take their
   ranks from a count per group; an exclusive scan of the counts gives
   each group's offset in the tile's region of the record list and one
   row of the offset table. The design has no atomics: a record's place
   is a function of the rows, and the record slots a call does not write
   keep whatever an earlier call left there (here: garbage).
2. **Group pass** — a group's segment length in every tile, their scan,
   and its records gathered ``GLANCE_CHUNK`` at a time in row order, each
   mapped to its tile by a binary search of the tile prefix; then one warp
   walks the chunk 32 records at a time: the lanes of one node match and
   the lowest adds its peers' values in lane order, so each bucket's sum
   is one left-to-right chain from 0.0, as ``np.bincount``'s.
3. **Eq. 1** — P = sum / count (NaN where empty), the neighbourhood's
   mean and σ as left-to-right sums over k, in Python floats.

The mirrors are held against ``spatial_ref``/``temporal_ref`` on
``chip_smoke.py``'s adversarial seeds and its :data:`GLANCE_CASES`
(order-dependent buckets of 2 to 8 rows, jobs scattered across rows, one
job holding every row, empty job slots, Eq. 1 ties, all-NaN
neighbourhoods, 10,000 nodes, a scenario axis of 64), at the kernel's
tile and chunk sizes and at small ones, so that tiles and chunks break
mid-group; and on the recorded snapshots of ``tests/test_torch_assess.py``
against ``NumpyBackend`` and the reference's Pallas kernels in interpret
mode (its child process). The wrappers' constants are checked against
the source, and the ``cuda`` tests (they skip without a card) run the
kernels on every glance case.
"""
import bisect
import math
import re
import sys
from fractions import Fraction
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
WARP = 32


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


# ---------------------------------------------------------------------------
# The mirrors
# ---------------------------------------------------------------------------
def spatial_rows(rho, node, kind, jls, running, n: int, jcap: int):
    """B1's reading of its rows: each row's group 2 * job + phase (-1:
    not used: not running, or its phase, node or job out of range), node
    and value."""
    g = 2 * jls.long() + kind.long()
    use = ((running == 1) & (kind >= 0) & (kind <= 1) & (node >= 0)
           & (node < n) & (jls >= 0) & (g < 2 * jcap))
    return torch.where(use, g, -1), node.long(), rho[None, :]


def temporal_rows(prog, tprog, node, jls, alive, n: int, jcap: int):
    use = (alive == 1) & (node >= 0) & (node < n) & (jls >= 0) & (jls < jcap)
    return (torch.where(use, jls.long(), -1), node.long(),
            torch.stack([prog, tprog]))


def row_pass(g, node, vals, G: int, tile: int = K.GLANCE_ROWS):
    """Records (node, values) in tile regions of ``tile`` and the (ntiles,
    G + 1) offset table, as the row pass writes them. Slots no row fills
    hold garbage, which no group pass may read."""
    cap = g.numel()
    ntiles = -(-cap // tile)
    rec_node = torch.full((ntiles * tile,), -7, dtype=torch.long)
    rec_val = torch.full((vals.shape[0], ntiles * tile), math.nan,
                         dtype=torch.float64)
    tab = torch.zeros((ntiles, G + 1), dtype=torch.long)
    gl = g.tolist()
    for t in range(ntiles):
        lo, hi = t * tile, min(cap, (t + 1) * tile)
        cnt = [0] * (G + 1)
        before = {}
        for w0 in range(lo, hi, WARP):          # the warps, in row order
            peers = {}                          # __match_any_sync
            for i in range(w0, min(w0 + WARP, hi)):
                peers.setdefault(gl[i], []).append(i)
            for grp, rows in peers.items():
                if grp < 0:
                    continue
                base = cnt[grp]                 # the leader's read and add
                cnt[grp] += len(rows)
                for rank, i in enumerate(rows):   # lanes below it
                    before[i] = base + rank
        off = np.concatenate([[0], np.cumsum(cnt)[:-1]])   # exclusive scan
        tab[t] = torch.from_numpy(off)
        for i, rank in before.items():
            slot = t * tile + int(off[gl[i]]) + rank
            rec_node[slot] = node[i]
            rec_val[:, slot] = vals[:, i]
    return rec_node, rec_val, tab


def group_pass(rec_node, rec_val, tab, grp: int, n: int,
               tile: int = K.GLANCE_ROWS, chunk: int = K.GLANCE_CHUNK):
    """One group block: (sums per value, counts) over its n nodes, or
    None for a group with no record."""
    length = (tab[:, grp + 1] - tab[:, grp]).tolist()
    pre = [0] + np.cumsum(length).tolist()
    sbase = [t * tile + int(tab[t, grp]) for t in range(tab.shape[0])]
    m = pre[-1]
    if m == 0:
        return None
    nv = rec_val.shape[0]
    acc = [[0.0] * n for _ in range(nv)]
    cnt = [0] * n
    nodes, vals = rec_node.tolist(), rec_val.tolist()
    for c0 in range(0, m, chunk):
        stage = []
        for k in range(c0, min(m, c0 + chunk)):
            t = bisect.bisect_right(pre, k) - 1  # pre[t] <= k < pre[t + 1]
            slot = sbase[t] + k - pre[t]
            stage.append((nodes[slot], [vals[q][slot] for q in range(nv)]))
        for e0 in range(0, len(stage), WARP):     # warp 0's slices
            peers = {}                            # __match_any_sync
            for rec in stage[e0:e0 + WARP]:
                peers.setdefault(rec[0], []).append(rec[1])
            for v, recs in peers.items():         # the lowest lane adds
                for val in recs:                  # in lane order
                    for q in range(nv):
                        acc[q][v] = acc[q][v] + val[q]
                cnt[v] += len(recs)
    return acc, cnt


def eq1(P, nh_rows) -> list:
    """Eq. 1 for every node with a P, in Python floats; False elsewhere."""
    out = [False] * len(P)
    for v, pv in enumerate(P):
        if math.isnan(pv):
            continue
        cnt, s = 0, 0.0
        for kk, u in enumerate(nh_rows[v]):
            x = P[u]
            valid = not math.isnan(x)
            cnt += valid
            xv = x if valid else 0.0
            s = xv if kk == 0 else s + xv
        denom = float(max(cnt, 1))
        mean = s / denom
        vs = 0.0
        for kk, u in enumerate(nh_rows[v]):
            x = P[u]
            sq = 0.0 if math.isnan(x) else (x - mean) * (x - mean)
            vs = sq if kk == 0 else vs + sq
        out[v] = cnt >= 2 and pv < mean - math.sqrt(vs / denom)
    return out


def spatial_mirror(rho, node, kind, jls, running, nh, jcap: int, *,
                   tile: int = K.GLANCE_ROWS, chunk: int = K.GLANCE_CHUNK):
    """B1 by the kernel's algorithm: (jcap, 2, n) bool, or (N, jcap, 2, n)
    for (N, cap) rows, as ``spatial_ref``."""
    if rho.dim() == 2:
        return torch.stack([
            spatial_mirror(rho[s], node[s], kind[s], jls[s], running[s], nh,
                           jcap, tile=tile, chunk=chunk)
            for s in range(rho.shape[0])])
    n = nh.shape[0]
    G = 2 * jcap
    recs = row_pass(*spatial_rows(rho, node, kind, jls, running, n, jcap),
                    G, tile)
    nh_rows = nh.tolist()
    fired = torch.zeros((G, n), dtype=torch.bool)
    for grp in range(G):
        got = group_pass(*recs, grp, n, tile, chunk)
        if got is None:                  # an empty group: all false
            continue
        (acc,), cnt = got
        P = [a / c if c > 0 else math.nan for a, c in zip(acc, cnt)]
        fired[grp] = torch.tensor(eq1(P, nh_rows))
    return fired.reshape(jcap, 2, n)


def temporal_mirror(prog, tprog, node, jls, alive, jcap: int, n: int, *,
                    tile: int = K.GLANCE_ROWS, chunk: int = K.GLANCE_CHUNK):
    """B2 by the kernel's algorithm: (ζ_now, ζ_prev), each (jcap, n), NaN
    where a bucket is empty, as ``temporal_ref``."""
    recs = row_pass(*temporal_rows(prog, tprog, node, jls, alive, n, jcap),
                    jcap, tile)
    z = torch.full((2, jcap, n), math.nan, dtype=torch.float64)
    for grp in range(jcap):
        got = group_pass(*recs, grp, n, tile, chunk)
        if got is None:                  # an empty group: all NaN
            continue
        acc, cnt = got
        have = torch.tensor(cnt) > 0
        for q in range(2):
            z[q, grp] = torch.where(
                have, torch.tensor(acc[q], dtype=torch.float64), math.nan)
    return z[0], z[1]


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _same(got, want):
    """Equal bit for bit (NaN where NaN; -0.0 is not +0.0)."""
    for g, w in zip(_tuple(got), _tuple(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.is_floating_point():
            assert torch.equal(torch.isnan(g), torch.isnan(w))
            assert torch.equal(g.nan_to_num(0.0).view(torch.int64),
                               w.nan_to_num(0.0).view(torch.int64))
        else:
            assert torch.equal(g, w)


# Tile and chunk sizes the mirrors also run at: tiles and chunks then
# break inside groups and inside warps' slices.
SMALL = ((K.GLANCE_ROWS, K.GLANCE_CHUNK), (32, 32), (64, 40))


@pytest.mark.parametrize("case", _chip_smoke().GLANCE_CASES)
def test_spatial_mirror_matches_plain_on_glance_cases(case):
    args = _chip_smoke().glance_inputs(case, 0, "cpu")["spatial"]
    want = TB.spatial_ref(*args)
    sizes = SMALL[:1] if case in _chip_smoke().GLANCE_NODES else SMALL
    for tile, chunk in sizes:
        _same(spatial_mirror(*args, tile=tile, chunk=chunk), want)
    assert want.any(), case


@pytest.mark.parametrize("case", _chip_smoke().GLANCE_CASES)
def test_temporal_mirror_matches_plain_on_glance_cases(case):
    args = _chip_smoke().glance_inputs(case, 0, "cpu")["temporal"]
    want = TB.temporal_ref(*args)
    sizes = SMALL[:1] if case in _chip_smoke().GLANCE_NODES else SMALL
    for tile, chunk in sizes:
        _same(temporal_mirror(*args, tile=tile, chunk=chunk), want)


@pytest.mark.parametrize("seed", range(8))
def test_mirrors_match_plain_on_adversarial_inputs(seed):
    adv = _chip_smoke().adversarial_inputs(seed, "cpu")
    _same(spatial_mirror(*adv["spatial"]), TB.spatial_ref(*adv["spatial"]))
    _same(temporal_mirror(*adv["temporal"]),
          TB.temporal_ref(*adv["temporal"]))
    _same(temporal_mirror(*adv["temporal"], tile=32, chunk=16),
          TB.temporal_ref(*adv["temporal"]))


@pytest.mark.parametrize("case", ["order", "ties"])
def test_spatial_mirror_with_scenario_axis(case):
    """64 scenarios in one call equal 64 single calls of the plain
    version (the kernel's scenario axis: blockIdx.y offsets rows, records,
    table and output)."""
    cs = _chip_smoke()
    scen = [cs.glance_inputs(case, s, "cpu")["spatial"] for s in range(64)]
    args = cs.stack_scenarios("spatial", scen)
    got = spatial_mirror(*args)
    assert got.shape[0] == 64
    for s in range(64):
        _same(got[s], TB.spatial_ref(*scen[s]))


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_spatial_mirror_on_sweep_inputs(name):
    args, _cols = _port_sweep(name).kernel_args("cpu")
    _same(spatial_mirror(*args["spatial"]), TB.spatial_ref(*args["spatial"]))


# The inputs on which spatial_ref's torch.sqrt, before it took np.sqrt on
# the CPU, was off by one unit in the last place at an Eq. 1 boundary
# node (an AVX512 host); numpy and the mirror agreed.
SQRT_SEEDS = [("order", 5), ("order", 31), ("empty_slots", 10),
              ("empty_slots", 54), ("n10000", 1), ("n10000", 3)]


@pytest.mark.parametrize("case,seed", SQRT_SEEDS)
def test_spatial_plain_and_mirror_match_numpy_at_sqrt_edges(case, seed):
    from repro_torch.core.metrics import spatial_slow_mask_batch_np
    args = _chip_smoke().glance_inputs(case, seed, "cpu")["spatial"]
    rho, node, kind, jls, running, nh, jcap = args
    n = nh.shape[0]
    use = (running == 1).numpy()
    seg = ((2 * jls.long() + kind.long()) * n + node.long()).numpy()[use]
    sums = np.bincount(seg, weights=rho.numpy()[use], minlength=2 * jcap * n)
    cnt = np.bincount(seg, minlength=2 * jcap * n)
    with np.errstate(invalid="ignore"):
        P = np.where(cnt > 0, sums / np.maximum(cnt, 1), np.nan)
    want = spatial_slow_mask_batch_np(P.reshape(2 * jcap, n), nh.numpy())
    want = torch.from_numpy(want.reshape(jcap, 2, n))
    _same(TB.spatial_ref(*args), want)
    _same(spatial_mirror(*args), want)


# ---------------------------------------------------------------------------
# What the glance cases hold
# ---------------------------------------------------------------------------
def _buckets(job, kind, node, used, n):
    return ((job * 2 + kind) * n + node)[used]


def test_order_case_sums_depend_on_the_order():
    """Every used (job, phase, node) bucket holds 2 to 8 rows, at
    scattered rows, and adding some bucket's values in another order
    gives other bits: a kernel that lost the row order would fail."""
    rho, node, kind, jls, running, nh, jcap = _chip_smoke().glance_inputs(
        "order", 0, "cpu")["spatial"]
    n = nh.shape[0]
    used = running == 1
    b = _buckets(jls.long(), kind.long(), node.long(), used, n)
    sizes = torch.bincount(b)
    sizes = sizes[sizes > 0]
    assert int(sizes.min()) == 2 and int(sizes.max()) == 8
    vals = rho[used]
    rng = np.random.default_rng(0)
    moved = 0
    for bucket in torch.unique(b).tolist():
        x = vals[b == bucket].tolist()
        fwd = 0.0
        for v in x:
            fwd = fwd + v
        other = 0.0
        for k in rng.permutation(len(x)):
            other = other + x[k]
        moved += fwd != other
    assert moved >= 10
    rows = torch.nonzero(used).flatten()
    assert int((rows[1:] - rows[:-1]).max()) > 1        # not contiguous


def test_scattered_and_one_job_cases():
    cs = _chip_smoke()
    rho, node, kind, jls, running, nh, jcap = cs.glance_inputs(
        "scattered", 0, "cpu")["spatial"]
    used = running == 1
    j = jls[used]
    assert float((j[1:] != j[:-1]).float().mean()) > 0.7   # interleaved
    for t in range(0, rho.numel(), K.GLANCE_ROWS):         # every tile
        tile = jls[t:t + K.GLANCE_ROWS][used[t:t + K.GLANCE_ROWS]]
        assert torch.unique(tile).numel() == jcap
    rho, node, kind, jls, running, nh, jcap = cs.glance_inputs(
        "one_job", 0, "cpu")["spatial"]
    assert bool((running == 1).all()) and bool((jls == 5).all())
    fired = TB.spatial_ref(rho, node, kind, jls, running, nh, jcap)
    assert fired[5].any() and not fired[torch.arange(jcap) != 5].any()


def test_empty_slots_case():
    args = _chip_smoke().glance_inputs("empty_slots", 0, "cpu")
    rho, node, kind, jls, running, nh, jcap = args["spatial"]
    assert jcap == 32
    assert set(jls[running == 1].tolist()) == {0, 5, 31}
    zn, _zp = TB.temporal_ref(*args["temporal"])
    empty = torch.ones(jcap, dtype=torch.bool)
    empty[[0, 5, 31]] = False
    assert bool(torch.isnan(zn[empty]).all())


def test_ties_case_sits_on_eq1_boundary():
    """Every neighbourhood holds two a's and two b's, so in exact
    arithmetic mean - sigma is min(a, b): the nodes whose own P is the
    smaller value sit on the boundary, where the float sums decide, and
    they decide both ways."""
    rho, node, kind, jls, running, nh, jcap = _chip_smoke().glance_inputs(
        "ties", 0, "cpu")["spatial"]
    n = nh.shape[0]
    G = 2 * jcap
    P = torch.full((G, n), math.nan, dtype=torch.float64)
    P[2 * jls.long() + kind.long(), node.long()] = rho     # one row each
    assert not torch.isnan(P).any()
    fired = TB.spatial_ref(rho, node, kind, jls, running, nh, jcap)
    fired = fired.reshape(G, n)
    on_edge = fired_edge = 0
    for grp in range(G):
        for v in range(n):
            xs = [Fraction(float(P[grp, u])) for u in nh[v].tolist()]
            mean = sum(xs) / 4
            var = sum((x - mean) ** 2 for x in xs) / 4
            lo = min(xs)
            assert var == ((max(xs) - lo) / 2) ** 2     # sigma is exact
            assert mean - (max(xs) - lo) / 2 == lo
            if Fraction(float(P[grp, v])) == lo:
                on_edge += 1
                fired_edge += bool(fired[grp, v])
            else:
                assert not fired[grp, v]
    assert on_edge == G * n // 2
    assert 0 < fired_edge < on_edge


def test_nan_hood_case_needs_the_count_test():
    """In even groups a node's four neighbours all lack rows; some such
    nodes have a negative P, which Eq. 1 without its count test (mean and
    sigma of no values are 0) would flag."""
    args = _chip_smoke().glance_inputs("nan_hood", 0, "cpu")["spatial"]
    rho, node, kind, jls, running, nh, jcap = args
    n = nh.shape[0]
    G = 2 * jcap
    used = running == 1
    P = torch.full((G, n), math.nan, dtype=torch.float64)
    sums = torch.zeros(G * n, dtype=torch.float64).index_add_(
        0, ((2 * jls.long() + kind.long()) * n + node.long())[used],
        rho[used])
    counts = torch.zeros(G * n).index_add_(
        0, ((2 * jls.long() + kind.long()) * n + node.long())[used],
        torch.ones(int(used.sum())))
    P = torch.where(counts > 0, sums / counts.clamp_min(1), P.flatten())
    P = P.reshape(G, n)
    hood_nan = torch.isnan(P[:, nh.long()]).all(dim=2)     # (G, n)
    trap = hood_nan & (P < 0)
    assert int(trap[0::2].sum()) > 10
    fired = TB.spatial_ref(*args).reshape(G, n)
    assert not fired[trap].any()
    assert fired[1::2].any()                 # odd groups: real tests


def test_n10000_case_crosses_the_old_limit():
    """10,000 nodes: the parent's B1 held 2n sums and counts of a job in
    one block's shared memory, (2n + 256) * 8 + (2n + 264) * 4 bytes, above
    a block's 232,448 from 9,557 nodes on; the new group block holds n."""
    args = _chip_smoke().glance_inputs("n10000", 0, "cpu")["spatial"]
    nh = args[5]
    n = nh.shape[0]
    assert n == 10_000
    old = (2 * n + 256) * 8 + (2 * n + 264) * 4
    assert old > K.MAX_SMEM >= (2 * 9556 + 256) * 8 + (2 * 9556 + 264) * 4
    fired = TB.spatial_ref(*args)
    assert fired[..., n - 300:].any()        # the band at the top
    assert int(nh[n - 1, 3]) == 0            # the last node's wraps to 0


def _table_in_smem(nv: int, count_bytes: int, n: int, cap: int) -> bool:
    """``glance_table_in_smem`` of ``assess.cu``: the stage (nv value
    columns and the node column of GLANCE_CHUNK records, the tile prefix
    and scan space) and one group's table (nv * n sums and n counts, in
    8-byte words) within a block's shared memory."""
    ntiles = -(-cap // K.GLANCE_ROWS)
    stage = (nv * K.GLANCE_CHUNK * 8
             + (K.GLANCE_CHUNK + 2 * ntiles + 1 + K.GLANCE_ROWS // 32) * 4)
    table = -(-(nv * n * 8 + n * count_bytes) // 8) * 8
    return stage + table <= K.MAX_SMEM


def test_group_tables_leave_shared_memory_past_the_limits():
    """C2: at 8,192 rows B1's group table (n float64 sums, n int counts)
    fits a block's shared memory up to 18,834 nodes and B2's (2n sums, n
    flag bytes) up to 13,053; past that each group's table lives in the
    work buffer. n10000 keeps both in shared memory; n20000 and n50000
    put both in device memory (the path that raised before)."""
    cs = _chip_smoke()
    for nv, cb, limit in ((1, 4, 18_834), (2, 1, 13_053)):
        assert _table_in_smem(nv, cb, limit, 8192)
        assert not _table_in_smem(nv, cb, limit + 1, 8192)
    for case, n in cs.GLANCE_NODES.items():
        cap = cs.glance_inputs(case, 0, "cpu")["spatial"][0].shape[0]
        assert cap == 8192
        assert _table_in_smem(1, 4, n, cap) == (n <= 18_834)
        assert _table_in_smem(2, 1, n, cap) == (n <= 13_053)


def _numpy_glance(sp, tp):
    """``NumpyBackend``'s arithmetic on the kernels' arguments: Eq. 1 from
    ``np.bincount`` sums and ``spatial_slow_mask_batch_np``, and the ζ
    sums from ``np.bincount``, NaN where a bucket is empty."""
    from repro_torch.core import metrics as M

    rho, node, kind, jls, running, nh, jcap = sp
    n = nh.shape[0]
    use = running.numpy() == 1
    seg = ((jls.numpy() * 2 + kind.numpy()) * n + node.numpy())[use]
    sums = np.bincount(seg, weights=rho.numpy()[use], minlength=jcap * 2 * n)
    counts = np.bincount(seg, minlength=jcap * 2 * n).astype(float)
    with np.errstate(invalid="ignore"):
        P = np.where(counts > 0, sums / np.maximum(counts, 1.0),
                     np.nan).reshape(jcap * 2, n)
    fired = M.spatial_slow_mask_batch_np(P, nh.numpy().astype(np.int64))
    prog, tprog, tnode, tjls, alive, tjcap, tn = tp
    use = alive.numpy() == 1
    seg = (tjls.numpy() * tn + tnode.numpy())[use]
    zn = np.bincount(seg, weights=prog.numpy()[use], minlength=tjcap * tn)
    zp = np.bincount(seg, weights=tprog.numpy()[use], minlength=tjcap * tn)
    cnt = np.bincount(seg, minlength=tjcap * tn)
    z = tuple(torch.from_numpy(np.where(cnt > 0, x, np.nan)
                               .reshape(tjcap, tn)) for x in (zn, zp))
    return torch.from_numpy(fired.reshape(jcap, 2, n)), z


@pytest.mark.parametrize("case", ["n20000", "n50000"])
def test_device_table_path_matches_numpy(case):
    """The group pass of C2's device-memory path is the same walk over
    the same records (only the table's address moves), so the mirror at
    20,000 and 50,000 nodes equals numpy's Eq. 1 and ζ sums byte for
    byte, as do the plain versions."""
    inp = _chip_smoke().glance_inputs(case, 0, "cpu")
    sp, tp = inp["spatial"], inp["temporal"]
    want_sp, want_tp = _numpy_glance(sp, tp)
    got_sp = spatial_mirror(*sp)
    _same(got_sp, want_sp)
    _same(TB.spatial_ref(*sp), want_sp)
    assert got_sp[..., -300:].any()
    _same(temporal_mirror(*tp), want_tp)
    _same(TB.temporal_ref(*tp), want_tp)


# ---------------------------------------------------------------------------
# The mirrors on the recorded snapshots: NumpyBackend and Pallas
# ---------------------------------------------------------------------------
MIRRORED = ("spatial_hits", "temporal_zeta")


@pytest.fixture
def mirrored(monkeypatch):
    """``TorchBackend("cpu")`` with B1 and B2 replaced by the mirrors, at
    small tiles and chunks."""
    monkeypatch.setattr(TB, "spatial", lambda *a: spatial_mirror(
        *a, tile=32, chunk=8))
    monkeypatch.setattr(TB, "temporal", lambda *a: temporal_mirror(
        *a, tile=32, chunk=8))


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
# Launchers
# ---------------------------------------------------------------------------
def _spatial_args(cap=8, n=4, jcap=2, f64=torch.float64):
    i32 = torch.zeros(cap, dtype=torch.int32)
    return (torch.zeros(cap, dtype=f64), i32, i32, i32, i32,
            torch.zeros((n, 4), dtype=torch.int32), jcap)


def _temporal_args(cap=8, n=4, jcap=2):
    f = torch.zeros(cap, dtype=torch.float64)
    i = torch.zeros(cap, dtype=torch.int32)
    return (f, f, i, i, i, jcap, n)


@pytest.mark.parametrize("bad", ["dtype", "jcap", "nodes", "empty"])
def test_glance_launchers_check_arguments_before_building(bad):
    spatial = {"dtype": _spatial_args(f64=torch.float32),
               "jcap": _spatial_args(jcap=0),
               "nodes": _spatial_args(n=0),
               "empty": _spatial_args(cap=0)}[bad]
    temporal = {"dtype": (torch.zeros(8, dtype=torch.float32),)
                + _temporal_args()[1:],
                "jcap": _temporal_args(jcap=0),
                "nodes": _temporal_args(n=0),
                "empty": _temporal_args(cap=0)}[bad]
    with pytest.raises((TypeError, ValueError)):
        K.launch_spatial(*spatial)
    with pytest.raises((TypeError, ValueError)):
        K.launch_temporal(*temporal)
    assert not K._libs and not K._glance_work


def test_wrapper_constants_match_the_source():
    src = Path(K.SOURCES["assess"]).read_text()
    defs = {k: v.strip() for k, v in
            re.findall(r"^#define (\w+) (.+)$", src, flags=re.M)}
    assert int(defs["NTHREADS"]) == K.GLANCE_ROWS
    assert defs["GLANCE_ROWS"] == "NTHREADS"
    assert int(defs["GLANCE_CHUNK"]) == K.GLANCE_CHUNK
    assert int(defs["GLANCE_MAX_SMEM"]) == K.MAX_SMEM
    assert {"spatial_jobs", "spatial_sweep_jobs", "temporal_jobs"} <= set(
        K.launches)
    # the library reports both, and the wrappers check them when it loads
    for fn in ("assess_glance_rows", "assess_glance_chunk"):
        assert f'extern "C" int {fn}()' in src


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")


@pytest.mark.cuda
@pytest.mark.parametrize("case", _chip_smoke().GLANCE_CASES)
def test_glance_cases_on_card(case):
    """Both kernels: two passes counted per call, twice the same bits,
    equal to the plain version; B1 as 64 scenarios in one call equal to
    64 single calls."""
    _need_card()
    cs = _chip_smoke()
    fns = {"spatial": (TB.spatial, TB.spatial_ref),
           "temporal": (TB.temporal, TB.temporal_ref)}
    for name, (wrapper, plain) in fns.items():
        dev = cs.glance_inputs(case, 0, "cuda")[name]
        keys = [name, name + "_jobs"]
        before = [K.launches[k] for k in keys]
        got = wrapper(*dev)
        assert [K.launches[k] for k in keys] == [b + 1 for b in before]
        assert cs._compare(got, wrapper(*dev))[0], (name, case)
        want = plain(*cs.glance_inputs(case, 0, "cpu")[name])
        _same(tuple(o.cpu() for o in cs._as_tuple(got)), cs._as_tuple(want))
    dev64 = cs.stack_scenarios("spatial", [
        cs.glance_inputs(case, s, "cuda")["spatial"] for s in range(64)])
    before = K.launches["spatial_sweep_jobs"]
    batched = TB.spatial(*dev64)
    assert K.launches["spatial_sweep_jobs"] == before + 1
    for s in range(64):
        one = TB.spatial(*cs.one_scenario("spatial", dev64, s))
        assert torch.equal(batched[s], one), s


@pytest.mark.cuda
def test_glance_work_buffer_reused_on_card():
    """A call allocates its outputs and nothing else: the work buffer is
    made on the first call and reused, and memory in use after a call
    whose outputs are dropped is what it was before."""
    _need_card()
    cs = _chip_smoke()
    args = cs.glance_inputs("scattered", 0, "cuda")
    for name in ("spatial", "temporal"):
        fn = getattr(TB, name)
        first = fn(*args[name])
        torch.cuda.synchronize()
        keys = set(K._glance_work)
        ptrs = {k: K._glance_work[k].data_ptr() for k in keys}
        before = torch.cuda.memory_allocated()
        second = fn(*args[name])
        out_bytes = sum(t.numel() * t.element_size()
                        for t in cs._as_tuple(second))
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() - before <= out_bytes + 512
        assert cs._compare(first, second)[0]
        del second
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() == before
        assert set(K._glance_work) == keys
        assert {k: K._glance_work[k].data_ptr() for k in keys} == ptrs
