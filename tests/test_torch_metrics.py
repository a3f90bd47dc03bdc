"""The port's torch mirrors of Eq. 1–4 (``repro_torch.core.metrics``'s
``*_torch``) against the reference's jax mirrors (``*_jax``) and against
the numpy functions, on the CPU.

Inputs are drawn with numpy from seeds over the ranges of the
reference's property tests (``tests/test_metrics.py``), with their
tolerances: jax runs in float32 here (``enable_x64`` is gone in jax
0.9), so the float32 mirrors are held to the jax ones and the float64
mirrors to numpy. A spatial or temporal mask may differ only at a
knife-edge row, where the tested value sits within 1e-4 of the decision
boundary, as the reference allows between float32 and float64; between
the float64 mirrors and numpy no row may differ. The reference's edge
cases (Eq. 4 a weighted mean, a constant history, recency; Eq. 1 a
uniform neighbourhood, a dead node, a lone live node; Eq. 3 a cliff and
no prior delta) run through the torch mirrors too.
"""
import numpy as np
import pytest
import torch

from repro.core import metrics as RM
from repro_torch.core import metrics as M

SEEDS = range(10)
DRAWS = 10          # draws a seed: 100 cases a parity test


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _floats(rng, lo, hi, n, nan_share=0.0):
    x = rng.uniform(lo, hi, n)
    if nan_share:
        x[rng.random(n) < nan_share] = np.nan
    return x


def test_mirrors_are_exported_and_not_ported_line_gone():
    for name in ("node_progress_rate_torch", "spatial_slow_mask_torch",
                 "temporal_slow_mask_torch", "eq4_estimate_torch"):
        assert name in M.__all__ and callable(getattr(M, name))
    assert "not ported" not in M.__doc__


# ---------------------------------------------------------------------------
# Eq. 4
# ---------------------------------------------------------------------------
def _history(rng):
    """A history of 1-12 outages in [0.1, 1000] and a window L in 1..8
    (``test_eq4_np_jax_parity``'s strategy)."""
    return list(_floats(rng, 0.1, 1000.0, rng.integers(1, 13))), \
        int(rng.integers(1, 9))


def _padded(history, L):
    h = history[-L:]
    return [np.nan] * (L - len(h)) + h


@pytest.mark.parametrize("seed", SEEDS)
def test_eq4_matches_jax_and_numpy(seed):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    for _ in range(DRAWS):
        history, L = _history(rng)
        want = RM.eq4_estimate_np(history, L)
        padded = _padded(history, L)
        got32 = float(M.eq4_estimate_torch(_t(padded, torch.float32), L))
        jax32 = float(RM.eq4_estimate_jax(jnp.asarray(padded, jnp.float32),
                                          L))
        assert got32 == pytest.approx(jax32, rel=1e-6)
        assert got32 == pytest.approx(want, rel=1e-5)
        got64 = float(M.eq4_estimate_torch(_t(padded), L))
        assert got64 == pytest.approx(want, rel=1e-12)


def test_eq4_edge_cases():
    rng = np.random.default_rng(100)
    for _ in range(DRAWS):
        history, L = _history(rng)
        window = history[-L:]
        est = float(M.eq4_estimate_torch(_t(_padded(history, L)), L))
        assert min(window) - 1e-9 <= est <= max(window) + 1e-9
        value = float(rng.uniform(0.5, 500.0))
        assert float(M.eq4_estimate_torch(_t([value] * L), L)) == \
            pytest.approx(value, rel=1e-9)
    big = float(M.eq4_estimate_torch(_t([1.0, 1.0, 1.0, 100.0]), 4))
    small = float(M.eq4_estimate_torch(_t([100.0, 1.0, 1.0, 1.0]), 4))
    assert big > 50.0 and small < 10.0
    # no history: NaN (numpy's None)
    assert np.isnan(float(M.eq4_estimate_torch(_t([np.nan] * 4), 4)))
    assert RM.eq4_estimate_np([], 4) is None


# ---------------------------------------------------------------------------
# Eq. 1
# ---------------------------------------------------------------------------
def _spatial_case(rng):
    """P over 3-12 nodes in [0, 10] or NaN, a ring neighbourhood of 2-6
    (``test_spatial_np_jax_parity``'s strategy)."""
    n = int(rng.integers(3, 13))
    P = _floats(rng, 0.0, 10.0, n, nan_share=0.3)
    k = min(int(rng.integers(2, 7)), n)
    offsets = np.arange(k) - (k // 2)
    nh = (np.arange(n)[:, None] + offsets[None, :]) % n
    return P, nh


def _decisive(P, nh):
    """Rows whose P lies more than 1e-4 from Eq. 1's boundary (the
    reference's test's margin)."""
    Pn = P[nh]
    valid = ~np.isnan(Pn)
    cnt = np.maximum(valid.sum(axis=1), 1)
    with np.errstate(invalid="ignore"):
        mean = np.nansum(Pn, axis=1) / cnt
        var = np.nansum(np.where(valid, (Pn - mean[:, None]) ** 2, 0.0),
                        axis=1) / cnt
        margin = np.abs(P - (mean - np.sqrt(var)))
    return ~np.isnan(margin) & (margin > 1e-4 * (1.0 + np.abs(P)))


@pytest.mark.parametrize("seed", SEEDS)
def test_spatial_matches_jax_and_numpy(seed):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    for _ in range(DRAWS):
        P, nh = _spatial_case(rng)
        want = RM.spatial_slow_mask_np(P, nh)
        got64 = M.spatial_slow_mask_torch(_t(P), torch.as_tensor(nh)).numpy()
        assert np.array_equal(got64, want)
        got32 = M.spatial_slow_mask_torch(_t(P, torch.float32),
                                          torch.as_tensor(nh)).numpy()
        jax32 = np.asarray(RM.spatial_slow_mask_jax(
            jnp.asarray(P, jnp.float32), jnp.asarray(nh)))
        ok = _decisive(P, nh)
        assert np.array_equal(got32[ok], jax32[ok])
        assert np.array_equal(got32[ok], want[ok])


def test_spatial_edge_cases():
    nh = (np.arange(8)[:, None] + np.arange(4)[None, :] - 2) % 8
    nh = torch.as_tensor(nh)
    assert not M.spatial_slow_mask_torch(_t(np.full(8, 3.0)), nh).any()
    P = _t([1.0, 1.0, 1.0, 0.01, 1.0, 1.0, 1.0, 1.0])
    mask = M.spatial_slow_mask_torch(P, nh)
    assert mask[3] and int(mask.sum()) == 1
    alone = np.full(8, np.nan)
    alone[2] = 0.001
    assert not M.spatial_slow_mask_torch(_t(alone), nh).any()


@pytest.mark.parametrize("seed", SEEDS)
def test_node_progress_rate_matches_jax_and_numpy(seed):
    """P(N^J) per node, nodes without tasks NaN: float64 within rounding
    of numpy (a scatter-add's order), float32 of jax."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    for _ in range(DRAWS):
        n_nodes, n_tasks = int(rng.integers(3, 13)), int(rng.integers(1, 40))
        progress = rng.uniform(0.0, 1.0, n_tasks)
        runtime = rng.uniform(0.0, 100.0, n_tasks)
        runtime[rng.random(n_tasks) < 0.1] = 0.0    # the 1e-9 guard
        node = rng.integers(0, n_nodes, n_tasks)
        want = RM.node_progress_rate_np(progress, runtime, node, n_nodes)
        got64 = M.node_progress_rate_torch(_t(progress), _t(runtime),
                                           torch.as_tensor(node),
                                           n_nodes).numpy()
        np.testing.assert_allclose(got64, want, rtol=1e-12)
        got32 = M.node_progress_rate_torch(
            _t(progress, torch.float32), _t(runtime, torch.float32),
            torch.as_tensor(node), n_nodes).numpy()
        jax32 = np.asarray(RM.node_progress_rate_jax(
            jnp.asarray(progress, jnp.float32),
            jnp.asarray(runtime, jnp.float32), jnp.asarray(node), n_nodes))
        np.testing.assert_allclose(got32, jax32, rtol=1e-6)
        assert np.array_equal(np.isnan(got32), np.isnan(want))


# ---------------------------------------------------------------------------
# Eq. 2–3
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
def test_temporal_matches_jax_and_numpy(seed):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    for _ in range(DRAWS):
        n = int(rng.integers(2, 11))
        zn = _floats(rng, 0.0, 100.0, n).astype(np.float32).astype(float)
        zp = _floats(rng, 0.0, 100.0, n).astype(np.float32).astype(float)
        dp = _floats(rng, 0.0, 100.0, n, nan_share=0.3
                     ).astype(np.float32).astype(float)
        m_np, d_np = RM.temporal_slow_mask_np(zn, zp, 3.0, dp)
        m64, d64 = M.temporal_slow_mask_torch(_t(zn), _t(zp), 3.0, _t(dp))
        assert np.array_equal(m64.numpy(), m_np)
        np.testing.assert_allclose(d64.numpy(), d_np, rtol=1e-15)
        m32, d32 = M.temporal_slow_mask_torch(
            _t(zn, torch.float32), _t(zp, torch.float32), 3.0,
            _t(dp, torch.float32))
        m_j, d_j = RM.temporal_slow_mask_jax(
            jnp.asarray(zn, jnp.float32), jnp.asarray(zp, jnp.float32), 3.0,
            jnp.asarray(dp, jnp.float32))
        margin = np.abs(d_np - 0.1 * dp)
        ok = np.isnan(margin) | (margin > 1e-4 * (1.0 + np.abs(d_np)))
        assert np.array_equal(m32.numpy()[ok], np.asarray(m_j)[ok])
        assert np.array_equal(m32.numpy()[ok], m_np[ok])
        np.testing.assert_allclose(d32.numpy(), np.asarray(d_j), rtol=1e-6)
        np.testing.assert_allclose(d32.numpy(), d_np, rtol=1e-5, atol=1e-5)


def test_temporal_edge_cases():
    mask, _ = M.temporal_slow_mask_torch(_t([10.05, 13.0]), _t([10.0, 10.0]),
                                         3.0, _t([1.0, 1.0]))
    assert mask[0] and not mask[1]
    mask, _ = M.temporal_slow_mask_torch(_t([0.0]), _t([0.0]), 3.0,
                                         _t([np.nan]))
    assert not mask.any()
    # dt of 0 takes the 1e-9 guard, as a number or a 0-d tensor
    _m, d = M.temporal_slow_mask_torch(_t([1.0]), _t([0.0]), _t(0.0),
                                       _t([1.0]))
    assert float(d[0]) == pytest.approx(1e9)
