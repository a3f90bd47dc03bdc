"""B10's Hopper body (Mamba-2's chunked SSD on the tensor cores) against
the reference package.

For bf16 inputs with head_dim and d_state each 64 or 128 and a chunk of
64 to 256 rows in steps of 64, ``ssd_fwd`` on the CPU runs
``ssd_tc_plain``: the body's decomposition (the chunk cumsum and C·Bᵀ per
group; each chunk's local state from the chunk alone; the state pass in
chunk order; each chunk's output) with each operand the kernel computes
and hands to the tensor cores (the weighted x, the scores P, the state
entering a chunk) rounded as a bf16 pair hi = bf16(v), lo = bf16(v -
hi), as the kernel does. Inputs are drawn with numpy from a seed and
handed to both packages.

1. **Against the reference** — its ``ssd_pallas`` in interpret mode (in
   this process) and its oracle: y within 2e-2 (bf16 inputs, y rounded to
   bf16; ``tests/test_kernels.py``), the float32 state within 2e-4, on
   shapes the Pallas kernel takes (s a multiple of the chunk), and against
   the oracle where it cannot go: a ragged tail, s < chunk, 8 groups, A
   near 0 and decays that underflow.
2. **Rounding** — the plain version rounds exactly the kernel's operands
   (no other tensor), each as a pair, and the pairs keep y and the state
   within 1e-5 of their scale of the unrounded ones.
3. **Chunk-parallel equals sequential** — in float32 (no rounding), the
   decomposition equals the SIMT body's sequential chunk walk and the
   oracle within 1e-5 of the output's scale.
4. **Body choice and constants** — ``ssd_tc`` per dtype, head_dim,
   d_state and chunk; the library's checks of its constants and choice.
5. **On the card** (marked ``cuda``; skips without one) — the four
   kernels against the plain version at the chip tolerances (y 2e-2, the
   state 2e-4), two launches giving the same bits, every sub-kernel
   counted once.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ref import ssd_reference as ref_ssd
from repro.kernels.ssd.ssd import ssd_pallas
from repro_torch.accel import kernels as K
from repro_torch.kernels.ssd import ssd as SSD
from repro_torch.kernels.ssd.ref import ssd_reference

F32_TOL = dict(rtol=2e-4, atol=2e-4)     # tests/test_kernels.py:157-160
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _inputs(seed, b, s, h, p, g, n, dtype=torch.bfloat16, a_scale=None,
            dt_shift=0.0):
    """(jax, torch) pairs of x, dt, A, B, C, D: x, B, C ~ N(0, 1) in
    ``dtype``; dt = softplus(N(0, 1) + dt_shift) and A = -exp(N(0, .5)) (or
    ``-a_scale``), D ~ N(0, 1), all float32."""
    rng = np.random.default_rng(seed)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) + dt_shift)) \
        .astype(np.float32)
    if a_scale is None:
        A = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    else:
        A = np.full(h, -a_scale, np.float32)
    B = rng.standard_normal((b, s, g, n)).astype(np.float32)
    C = rng.standard_normal((b, s, g, n)).astype(np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    out = []
    for name, v in zip("x dt A B C D".split(), (x, dt, A, B, C, D)):
        typed = name in ("x", "B", "C")
        out.append((jnp.asarray(v, jdt if typed else jnp.float32),
                    torch.from_numpy(v).to(dtype if typed
                                           else torch.float32)))
    return [j for j, _t in out], [t for _j, t in out]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(
        got, torch.Tensor) else got, np.float32), np.asarray(
        want.float() if isinstance(want, torch.Tensor) else want,
        np.float32), **tol)


# ---------------------------------------------------------------------------
# 1. Against the reference
# ---------------------------------------------------------------------------
# (b, s, h, p, g, n, chunk), each taken by the Hopper body
PALLAS_CASES = [(1, 256, 2, 64, 1, 128, 128),
                (2, 128, 4, 64, 2, 64, 64),
                (1, 256, 2, 128, 1, 128, 256),
                (1, 192, 4, 128, 1, 64, 192)]


@pytest.mark.parametrize("case", PALLAS_CASES, ids=str)
def test_tc_plain_matches_reference_pallas(case):
    b, s, h, p, g, n, chunk = case
    assert K.ssd_tc(torch.bfloat16, p, n, chunk)
    jargs, targs = _inputs(1 + s + p, b, s, h, p, g, n)
    y, st = SSD.ssd_fwd(*targs, chunk=chunk)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    assert tuple(st.shape) == (b, h, p, n)
    want_y, want_s = ssd_pallas(*jargs, chunk=chunk, interpret=True)
    _close(y, want_y, BF16_TOL)
    _close(st, want_s, F32_TOL)
    ref_y, ref_s = ref_ssd(*jargs, chunk=chunk)
    _close(y, ref_y, BF16_TOL)
    _close(st, ref_s, F32_TOL)


# ragged tails, s < chunk, 8 groups (the Pallas kernel asserts s % chunk
# == 0); effective chunks: 128, 128, 64, 256
ORACLE_CASES = [(2, 300, 4, 64, 2, 128, 128),
                (1, 128, 4, 64, 1, 128, 256),
                (1, 130, 8, 128, 8, 64, 64),
                (1, 520, 4, 64, 1, 128, 256)]


@pytest.mark.parametrize("decay", ["mixed", "near_zero", "underflow"])
@pytest.mark.parametrize("case", ORACLE_CASES, ids=str)
def test_tc_plain_matches_oracle_where_pallas_cannot(case, decay):
    """A near 0 barely decays the state; A at -16 with large dt makes
    every decay past the diagonal underflow to 0 (exp is never taken of
    a positive exponent, so nothing overflows)."""
    b, s, h, p, g, n, chunk = case
    assert K.ssd_tc(torch.bfloat16, p, n, min(chunk, s))
    kw = {"mixed": {}, "near_zero": dict(a_scale=1e-4),
          "underflow": dict(a_scale=16.0, dt_shift=3.0)}[decay]
    _j, targs = _inputs(2 + s, b, s, h, p, g, n, **kw)
    y, st = SSD.ssd_fwd(*targs, chunk=chunk)
    assert torch.isfinite(y.float()).all() and torch.isfinite(st).all()
    want_y, want_s = ssd_reference(*targs, chunk=chunk)
    _close(y, want_y, BF16_TOL)
    _close(st, want_s, F32_TOL)


# ---------------------------------------------------------------------------
# 2. Rounding at the kernel's places
# ---------------------------------------------------------------------------
def test_tc_plain_rounds_the_kernel_operands(monkeypatch):
    """Exactly these are rounded to bf16, each as a pair (hi, then the
    remainder): x·w once for all chunks (b, chunks, Q, h, p), then per
    chunk the state entering it (b, h, p, n) and the scores P (b, h, Q,
    Q)."""
    b, s, h, p, g, n, chunk = 1, 200, 2, 64, 1, 128, 64
    _j, targs = _inputs(3, b, s, h, p, g, n)
    seen = []
    orig = SSD._bf16
    monkeypatch.setattr(SSD, "_bf16", lambda t: seen.append(
        tuple(t.shape)) or orig(t))
    SSD.ssd_fwd(*targs, chunk=chunk)
    nc = -(-s // chunk)
    want = [(b, nc, chunk, h, p)] * 2 \
        + ([(b, h, p, n)] * 2 + [(b, h, chunk, chunk)] * 2) * nc
    assert seen == want


def test_tc_pairs_keep_y_and_the_state_near_float32(monkeypatch):
    b, s, h, p, g, n, chunk = 2, 256, 4, 64, 2, 128, 128
    _j, targs = _inputs(4, b, s, h, p, g, n)
    y, st = SSD.ssd_tc_plain(*targs, chunk=chunk)
    # the same values in float32: the same decomposition, unrounded
    y_f, st_f = SSD.ssd_tc_plain(*(t.float() for t in targs), chunk=chunk)
    # a pair keeps each operand to about 2^-16; y differs by at most its
    # own bf16 rounding flipping (one unit in the last place, 2^-7 of |y|)
    # beside float32 differences of 1e-5 of its scale
    assert not torch.equal(st, st_f)
    torch.testing.assert_close(st, st_f, rtol=1e-5,
                               atol=1e-5 * float(st_f.abs().max()))
    torch.testing.assert_close(y.float(), y_f.float(), rtol=2.0 ** -7,
                               atol=1e-5 * float(y_f.float().abs().max()))
    # single bf16 roundings would not: |P| and the state reach tens
    monkeypatch.setattr(SSD, "_pair", SSD._bf16)
    y1, _ = SSD.ssd_tc_plain(*targs, chunk=chunk)
    assert float((y1.float() - y_f.float()).abs().max()) > 2e-2


# ---------------------------------------------------------------------------
# 3. The chunk-parallel form equals the sequential one
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", [(2, 300, 4, 64, 2, 128, 128),
                                  (1, 130, 8, 128, 8, 64, 64),
                                  (1, 100, 2, 64, 1, 64, 32)], ids=str)
def test_chunk_parallel_equals_sequential(case):
    b, s, h, p, g, n, chunk = case
    _j, targs = _inputs(5, b, s, h, p, g, n, dtype=torch.float32)
    assert not K.ssd_tc(torch.float32, p, n, chunk)   # the SIMT walk
    y, st = SSD.ssd_tc_plain(*targs, chunk=chunk)   # float32: unrounded
    for want_y, want_s in (SSD.ssd_plain(*targs, chunk=chunk),
                           ssd_reference(*targs, chunk=chunk)):
        torch.testing.assert_close(y, want_y, rtol=1e-5,
                                   atol=1e-5 * float(want_y.abs().max()))
        torch.testing.assert_close(st, want_s, rtol=1e-5,
                                   atol=1e-5 * float(want_s.abs().max()))


def test_tc_plain_writes_the_state_into_a_given_tensor():
    _j, targs = _inputs(6, 1, 128, 2, 64, 1, 64)
    out = torch.full((1, 2, 64, 64), float("nan"))
    y, st = SSD.ssd_fwd(*targs, chunk=64, out_state=out)
    assert st is out and torch.isfinite(out).all()
    y2, st2 = SSD.ssd_tc_plain(*targs, chunk=64)
    assert torch.equal(y, y2) and torch.equal(out, st2)


# ---------------------------------------------------------------------------
# 4. Body choice and constants
# ---------------------------------------------------------------------------
def test_body_choice():
    bf16, f32 = torch.bfloat16, torch.float32
    for p in K.SSD_DIMS:
        for n in K.SSD_DIMS:
            for q in (32, 64, 100, 128, 192, 256, 320):
                want = p in (64, 128) and n in (64, 128) and q % 64 == 0 \
                    and q <= 256
                assert K.ssd_tc(bf16, p, n, q) == want
                assert not K.ssd_tc(f32, p, n, q)
    assert (K.SSD_TC_DIMS, K.SSD_TC_TILE, K.SSD_TC_MAX_CHUNK) == (
        (64, 128), 64, 256)


def test_body_follows_the_effective_chunk():
    """The chunk is ``min(chunk, s)``, except that a sequence of one chunk
    runs as one chunk of s rounded up to the 64-row tile where the Hopper
    body then takes it: a short bf16 prompt of any length takes the
    Hopper body's plain version; chunks of 100 rows over a longer one
    take the SIMT body's."""
    bf16, f32 = torch.bfloat16, torch.float32
    for s, chunk, q, tc in ((100, 256, 128, True), (128, 256, 128, True),
                            (64, 256, 64, True), (40, 256, 64, True),
                            (300, 100, 100, False)):
        assert K.ssd_chunk(bf16, 64, 128, s, chunk) == q
        assert K.ssd_chunk(f32, 64, 128, s, chunk) == min(chunk, s)
        _j, targs = _inputs(7, 1, s, 2, 64, 1, 128)
        y, st = SSD.ssd_plain(*targs, chunk=chunk)
        y_tc, st_tc = SSD.ssd_tc_plain(*targs, chunk=q)
        assert (torch.equal(y, y_tc) and torch.equal(st, st_tc)) == tc
    # p and n of 16 or 32 keep the SIMT body at any length
    assert K.ssd_chunk(bf16, 32, 128, 100, 256) == 100
    assert K.ssd_chunk(bf16, 64, 16, 40, 256) == 40


def test_a_padded_chunk_is_the_same_scan():
    """One chunk of s rows rounded up to the tile (rows past s zero, the
    identity) gives what one chunk of exactly s rows gives, in float32
    (no rounding) within 1e-6 of the output's scale."""
    _j, targs = _inputs(8, 2, 100, 4, 64, 1, 128, dtype=torch.float32)
    y, st = SSD.ssd_tc_plain(*targs, chunk=128)
    want_y, want_s = SSD.ssd_plain(*targs, chunk=100)
    torch.testing.assert_close(y, want_y, rtol=1e-6,
                               atol=1e-6 * float(want_y.abs().max()))
    torch.testing.assert_close(st, want_s, rtol=1e-6,
                               atol=1e-6 * float(want_s.abs().max()))


def _fake_ssd_library(**override):
    fns = dict(ssd_fwd=lambda *a: 0, ssd_fwd_tc=lambda *a: 0,
               ssd_smem=lambda *a: 0,
               ssd_tc=lambda is_bf16, p, n, q: int(
                   bool(is_bf16) and p in (64, 128) and n in (64, 128)
                   and q % 64 == 0 and 64 <= q <= 256),
               ssd_tile_rows=lambda: 64, ssd_tc_tile=lambda: 64,
               ssd_tc_max_chunk=lambda: 256)
    fns.update(override)
    return types.SimpleNamespace(**fns)


def test_library_checks_hold_the_wrappers():
    K._bind("ssd", _fake_ssd_library())
    with pytest.raises(RuntimeError, match="tile"):
        K._bind("ssd", _fake_ssd_library(ssd_tc_max_chunk=lambda: 512))
    with pytest.raises(RuntimeError, match="body"):
        K._bind("ssd", _fake_ssd_library(
            ssd_tc=lambda is_bf16, p, n, q: int(bool(is_bf16))))
    with pytest.raises(RuntimeError, match="chunk 320"):
        K._bind("ssd", _fake_ssd_library(
            ssd_tc=lambda is_bf16, p, n, q: int(
                bool(is_bf16) and p in (64, 128) and n in (64, 128)
                and q % 64 == 0)))


# ---------------------------------------------------------------------------
# 5. On the card (skips without one)
# ---------------------------------------------------------------------------
TC_KEYS = ("ssd", "ssd_tc", "ssd_prep", "ssd_state", "ssd_out")
CARD_CASES = [(4, 2048, 80, 64, 1, 128, 256),    # Mamba2-2.7B's layer
              (2, 300, 8, 64, 2, 128, 128),      # ragged, 2 groups
              (1, 130, 8, 128, 8, 64, 64),       # 8 groups, p 128
              (1, 128, 4, 128, 1, 128, 256),     # s < chunk
              (2, 520, 8, 64, 1, 64, 192)]       # a 192-row chunk


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=str)
def test_tc_kernels_match_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    b, s, h, p, g, n, chunk = case
    _j, targs = _inputs(8 + s, b, s, h, p, g, n)
    args = [t.cuda() for t in targs]
    K.reset_launches()
    y, st = SSD.ssd_fwd(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert {k: K.launches[k] for k in TC_KEYS} == dict.fromkeys(TC_KEYS, 1)
    y2, st2 = SSD.ssd_fwd(*args, chunk=chunk)
    assert torch.equal(y, y2) and torch.equal(st, st2)
    want_y, want_s = SSD.ssd_plain(*args, chunk=chunk)
    torch.testing.assert_close(y.float(), want_y.float(), **BF16_TOL)
    torch.testing.assert_close(st, want_s, **F32_TOL)
