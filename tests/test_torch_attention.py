"""The port's attention kernels B6 and B9 against the reference package.

Inputs are drawn with numpy from a seed and handed to both packages (as
bfloat16 they round the same way in both). On the CPU the port's
``flash_attention_fwd`` and ``decode_attention_fwd`` run their plain
torch versions — the blockwise online softmax each CUDA kernel computes,
on the kernel's tiles.

1. **B6 plain version** — out and lse against the reference oracle
   (``attention_reference``, ``attention_reference_with_lse``) and the
   reference's Pallas forward in interpret mode, over the shape and dtype
   grid of ``tests/test_kernels.py`` (MHA, MQA, GQA, sq < sk, causal on
   and off, a window), plus ragged shapes the reference cannot take, at
   its tolerances (bf16 2e-2, f32 2e-5). For the Hopper body's inputs
   (bf16 at head_dim 64, 80 and 128) the plain version rounds p to bf16
   before ``p @ v`` and walks 128 x 128 tiles: held against the Pallas
   kernel (p in f32) and the oracle at the same bf16 limits; which body,
   and so which tiles, each (dtype, head_dim) takes; at head_dim 80 the
   same function as on inputs zero-padded to 128.
2. **B9 plain version** — against ``decode_attention_reference`` and
   ``decode_attention_pallas`` in interpret mode, valid lengths at 1, at
   tile edges and at the cache size (head_dim 80 too); NaN for a
   sequence with no key. B7's and B8's plain versions at head_dim 80
   against ``jax.grad`` through the reference's Pallas kernels in
   interpret mode and through its oracle (the other head sizes are in
   ``tests/test_torch_attention_bwd.py``).
3. **Oracles** — the port's ``ref.py`` functions equal the reference's.
4. **Ops** — ``impl`` selection, ``kv_valid_len`` through the oracle,
   devices the kernels cannot run on refused (no fallback),
   ``impl="dist"`` refusing to run off a mesh, argument checks. The backward kernels B7/B8
   are held in ``tests/test_torch_attention_bwd.py``.
5. **On the card** (marked ``cuda``; they skip without one) — each CUDA
   kernel against its plain version on boundary inputs; B6's Hopper body
   at its tile edges (head_dim 80 too), repeat launches byte-identical,
   and its launches counted as ``flash_fwd_tc`` (f32 and bf16 at head_dim
   16/32 stay on the SIMT body).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.decode_attention import (
    decode_attention_pallas)
from repro.kernels.decode_attention.ref import (
    decode_attention_reference as ref_decode)
from repro.kernels.flash_attention import flash_attention as RFA
from repro.kernels.flash_attention.ref import (
    attention_reference as ref_attention,
    attention_reference_with_lse as ref_attention_lse)
from repro_torch.accel import kernels as K
from repro_torch.kernels.decode_attention import decode_attention as DA
from repro_torch.kernels.decode_attention import ops as DOPS
from repro_torch.kernels.decode_attention.ref import \
    decode_attention_reference
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.flash_attention import ops as FOPS
from repro_torch.kernels.flash_attention.ref import (
    attention_reference, attention_reference_with_lse)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype: str):
    # tests/test_kernels.py:21-23
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, dtype, *shapes):
    """Each shape drawn N(0, 1) with numpy, as (jax, torch) pairs of the
    same values in ``dtype``."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    out = []
    for shape in shapes:
        x = rng.standard_normal(shape).astype(np.float32)
        out.append((jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)))
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# 1. B6's plain version
# ---------------------------------------------------------------------------
FWD_SHAPES = [
    (1, 128, 128, 2, 2, 32),     # MHA square
    (2, 128, 128, 4, 1, 16),     # MQA
    (1, 256, 256, 4, 2, 32),     # GQA, multi-block
    (1, 128, 256, 2, 1, 32),     # decode-ish: q shorter than kv
]


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d", FWD_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_reference(b, sq, sk, hq, hkv, d, causal,
                                       dtype):
    (jq, q), (jk, k), (jv, v) = _inputs(
        0, dtype, (b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d))
    out, lse = FA.flash_attention_fwd(q, k, v, causal=causal)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (b, hq, sq)
    pal, pal_lse = RFA.flash_attention_fwd(jq, jk, jv, causal=causal,
                                           block_q=64, block_k=128,
                                           interpret=True)
    want = ref_attention(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(out), _np(want), **_tol(dtype))
    np.testing.assert_allclose(_np(out), _np(pal), **_tol(dtype))
    np.testing.assert_allclose(_np(lse), _np(pal_lse), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d", [
    (1, 128, 128, 4, 4, 80),     # hubert-xlarge's head_dim, MHA
    (2, 130, 200, 4, 2, 80),     # GQA, ragged tiles, q shorter than kv
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_head_dim_80_matches_reference(b, sq, sk, hq, hkv, d,
                                                   causal, dtype):
    """head_dim 80 (hubert-xlarge: 1,280 over 16 heads, non-causal) on
    the tiles of the body that takes it (bf16: the Hopper body's 128 x
    128, p rounded to bf16; f32: the SIMT body's 64 x 64), against the
    reference's Pallas forward in interpret mode (which takes any
    head_dim) and its oracle."""
    tc = K.flash_fwd_tc(DTYPES[dtype][1], d)
    assert d in K.HEAD_DIMS and tc == (dtype == "bfloat16")
    assert K.flash_fwd_tiles(DTYPES[dtype][1], d) == \
        ((128, 128) if tc else (64, 64))
    (jq, q), (jk, k), (jv, v) = _inputs(
        16, dtype, (b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d))
    out, lse = FA.flash_attention_fwd(q, k, v, causal=causal)
    assert out.shape == q.shape and lse.shape == (b, hq, sq)
    want, want_lse = ref_attention_lse(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(out), _np(want), **_tol(dtype))
    np.testing.assert_allclose(_np(lse), _np(want_lse), rtol=2e-5,
                               atol=2e-5)
    if sq % 64 == 0 and sk % 64 == 0:     # the Pallas grid asserts tiles
        pal, pal_lse = RFA.flash_attention_fwd(jq, jk, jv, causal=causal,
                                               block_q=64, block_k=64,
                                               interpret=True)
        np.testing.assert_allclose(_np(out), _np(pal), **_tol(dtype))
        np.testing.assert_allclose(_np(lse), _np(pal_lse), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,window", [
    (1, 256, 256, 2, 2, 32, 64),    # tests/test_kernels.py's window case
    (1, 200, 300, 8, 2, 32, 64),    # ragged, q_offset 100, GQA-4
    (2, 77, 77, 4, 4, 16, 5),       # a window smaller than a tile
])
def test_flash_plain_window_and_lse(b, sq, sk, hq, hkv, d, window):
    (jq, q), (jk, k), (jv, v) = _inputs(
        1, "float32", (b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d))
    out, lse = FA.flash_attention_fwd(q, k, v, causal=True, window=window)
    want, want_lse = ref_attention_lse(jq, jk, jv, causal=True,
                                       window=window)
    np.testing.assert_allclose(_np(out), _np(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(lse), _np(want_lse), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d", [
    (2, 100, 130, 4, 1, 16),     # neither length a multiple of the tile
    (1, 65, 65, 48, 1, 64),      # a group of 48, one row past a tile
    (1, 1, 200, 8, 2, 32),       # one query row at the end of the keys
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_ragged_tiles(b, sq, sk, hq, hkv, d, causal):
    (jq, q), (jk, k), (jv, v) = _inputs(
        2, "float32", (b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d))
    out, lse = FA.flash_attention_fwd(q, k, v, causal=causal)
    want, want_lse = ref_attention_lse(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(out), _np(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(lse), _np(want_lse), rtol=2e-5,
                               atol=2e-5)


# The Hopper body's inputs: bf16 at head_dim 64, 80 and 128, p rounded to
# bf16 before p @ v; the Pallas kernel keeps p in f32. Its grid divides:
# blocks of 64 x 128 (the reference's divisibility), the port's 128 x 128.
TC_SHAPES = [
    (1, 128, 128, 2, 2, 64, True, 0),      # MHA, the training layout
    (1, 256, 256, 4, 1, 128, True, 0),     # a group of 4, two tiles
    (2, 128, 256, 8, 2, 64, True, 0),      # sq < sk: q_offset 128
    (1, 256, 256, 4, 2, 128, False, 0),    # not causal
    (1, 256, 256, 2, 2, 64, True, 96),     # a window crossing a tile
    # head_dim 80 (hubert-xlarge): five 16-column tiles a row on the card
    (1, 256, 256, 16, 16, 80, False, 0),   # hubert's layout, non-causal
    (1, 256, 256, 8, 2, 80, True, 0),      # a group of 4
    (2, 128, 256, 4, 2, 80, True, 0),      # sq < sk: q_offset 128
    (1, 256, 256, 2, 2, 80, True, 96),     # a window crossing a tile
]


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal,window", TC_SHAPES)
def test_flash_plain_bf16_rounded_p_matches_reference(b, sq, sk, hq, hkv,
                                                      d, causal, window):
    (jq, q), (jk, k), (jv, v) = _inputs(
        20 + d + window, "bfloat16", (b, sq, hq, d), (b, sk, hkv, d),
        (b, sk, hkv, d))
    assert K.flash_fwd_tc(q.dtype, d)
    out, lse = FA.flash_attention_fwd(q, k, v, causal=causal,
                                      window=window)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    pal, pal_lse = RFA.flash_attention_fwd(jq, jk, jv, causal=causal,
                                           window=window, block_q=64,
                                           block_k=128, interpret=True)
    want, want_lse = ref_attention_lse(jq, jk, jv, causal=causal,
                                       window=window)
    np.testing.assert_allclose(_np(out), _np(pal), **_tol("bfloat16"))
    np.testing.assert_allclose(_np(out), _np(want), **_tol("bfloat16"))
    # l sums the f32 p: lse keeps the f32 limit
    np.testing.assert_allclose(_np(lse), _np(pal_lse), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(lse), _np(want_lse), rtol=2e-5,
                               atol=2e-5)


def test_flash_plain_rounds_p_only_for_the_hopper_body():
    """bf16 at head_dim 64: p @ v takes bf16-rounded p, so the out differs
    from an f32-p walk of the same tiles by rounding alone; lse is the
    same bits (l sums the f32 p)."""
    (_, q), (_, k), (_, v) = _inputs(21, "bfloat16", (1, 200, 4, 64),
                                     (1, 200, 2, 64), (1, 200, 2, 64))
    out, lse = FA.flash_attention_plain(q, k, v)
    # the same walk with p kept in f32: the float32 copy's path
    f_out, f_lse = FA.flash_attention_plain(q.float(), k.float(), v.float(),
                                            block_q=128, block_k=128)
    assert torch.equal(lse, f_lse)
    assert not torch.equal(out.float(), f_out.to(torch.bfloat16).float())
    torch.testing.assert_close(out.float(), f_out, rtol=2e-2, atol=2e-2)


def _bf16_ulps(got, want):
    """|got - want| in units in the last place of bf16 at ``want``."""
    _, e = torch.frexp(want.float())
    return (got.float() - want.float()).abs() / torch.ldexp(
        torch.ones_like(want.float()), e - 8)


@pytest.mark.parametrize("b,sq,sk,hq,hkv,causal,window", [
    (1, 200, 200, 4, 4, False, 0),    # hubert's layout, ragged tiles
    (1, 130, 256, 8, 2, True, 40),    # a group of 4, sq < sk, a window
])
def test_flash_plain_head_dim_80_is_the_padded_function(b, sq, sk, hq, hkv,
                                                        causal, window):
    """bf16 at head_dim 80 (the Hopper body's five 16-column tiles on the
    card) computes the function of the inputs zero-padded to 128 and
    cropped: zero columns change neither the scores nor the kept
    columns. Out within two bf16 units in the last place, lse equal."""
    d, pad = 80, 128
    assert K.flash_fwd_tc(torch.bfloat16, d)
    assert K.flash_fwd_tc(torch.bfloat16, pad)
    (_, q), (_, k), (_, v) = _inputs(
        22, "bfloat16", (b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d))
    opts = dict(causal=causal, window=window, scale=d ** -0.5)
    out, lse = FA.flash_attention_plain(q, k, v, **opts)
    wide = [torch.nn.functional.pad(x, (0, pad - d)) for x in (q, k, v)]
    w_out, w_lse = FA.flash_attention_plain(*wide, **opts)
    assert out.shape[-1] == d and w_out.shape[-1] == pad
    assert not w_out[..., d:].any()
    assert float(_bf16_ulps(out, w_out[..., :d]).max()) <= 2.0
    assert torch.equal(lse, w_lse)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", K.HEAD_DIMS)
def test_flash_fwd_tiles_follow_the_body(dtype, d):
    """bf16 at head_dim 64/80/128 takes the Hopper body's 128 x 128
    tiles, every other input the SIMT body's 64 x 64; the backward's stay
    64 x 64 whatever the forward's. The library is checked against the
    same choice when it loads (``kernels._bind``)."""
    tc = dtype == torch.bfloat16 and d in (64, 80, 128)
    assert K.flash_fwd_tc(dtype, d) == tc
    assert K.flash_fwd_tiles(dtype, d) == ((128, 128) if tc else (64, 64))
    assert (FA.BWD_BLOCK_Q, FA.BWD_BLOCK_K) == (64, 64)


def test_flash_plain_walks_the_kernels_tiles():
    """Other tile sizes give the same function (to rounding), and the
    causal skip leaves the upper triangle untouched."""
    (_, q), (_, k), (_, v) = _inputs(3, "float32", (1, 96, 4, 16),
                                     (1, 160, 2, 16), (1, 160, 2, 16))
    a, la = FA.flash_attention_plain(q, k, v)
    b, lb = FA.flash_attention_plain(q, k, v, block_q=32, block_k=16)
    torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(la, lb, rtol=2e-5, atol=2e-5)
    # with sq == sk only the last query sees the last key: changing that
    # key leaves every other row bit-equal (its score is -1e30, p = 0)
    k, v = k[:, :96], v[:, :96]
    k2, v2 = k.clone(), v.clone()
    k2[:, -1] += 5.0
    v2[:, -1] -= 5.0
    c, _ = FA.flash_attention_plain(q, k2, v2)
    d, _ = FA.flash_attention_plain(q, k, v)
    assert torch.equal(c[:, :-1], d[:, :-1])
    assert not torch.equal(c[:, -1], d[:, -1])


# ---------------------------------------------------------------------------
# 2. B9's plain version
# ---------------------------------------------------------------------------
DECODE_SHAPES = [
    (2, 128, 4, 2, 32),
    (4, 256, 4, 1, 16),
    (1, 512, 8, 8, 64),
    (3, 300, 48, 1, 32),         # a group of 48, a ragged cache
]


def _valid(seed, b, sk):
    """Valid lengths at 1, at tile edges ±1 and at the cache size, then
    random ones."""
    edge = [1, K.DECODE_BLOCK_K - 1, K.DECODE_BLOCK_K,
            K.DECODE_BLOCK_K + 1, sk]
    rng = np.random.default_rng(seed)
    pick = edge + list(rng.integers(1, sk + 1, b))
    return np.array([min(x, sk) for x in pick[:b]], np.int32)


@pytest.mark.parametrize("b,sk,hq,hkv,d", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_reference(b, sk, hq, hkv, d, dtype):
    (jq, q), (jk, k), (jv, v) = _inputs(
        4, dtype, (b, hq, d), (b, sk, hkv, d), (b, sk, hkv, d))
    valid = _valid(b + sk, b, sk)
    out = DA.decode_attention_fwd(q, k, v, torch.from_numpy(valid))
    assert out.dtype == q.dtype and out.shape == q.shape
    want = ref_decode(jq, jk, jv, jnp.asarray(valid))
    np.testing.assert_allclose(_np(out), _np(want), **_tol(dtype))
    if sk % 128 == 0:   # the Pallas kernel asserts divisibility
        pal = decode_attention_pallas(jq, jk, jv, jnp.asarray(valid),
                                      block_k=128, interpret=True)
        np.testing.assert_allclose(_np(out), _np(pal), **_tol(dtype))


def test_decode_valid_edges_and_no_key():
    (jq, q), (jk, k), (jv, v) = _inputs(5, "float32", (8, 8, 32),
                                        (8, 200, 2, 32), (8, 200, 2, 32))
    valid = np.array([1, 63, 64, 65, 127, 128, 199, 200], np.int32)
    out = DA.decode_attention_fwd(q, k, v, torch.from_numpy(valid))
    want = ref_decode(jq, jk, jv, jnp.asarray(valid))
    np.testing.assert_allclose(_np(out), _np(want), rtol=2e-5, atol=2e-5)
    # valid = 0 (a precondition breach) gives NaN, as in the reference
    none = np.array([0, 5, 0, 9, 1, 1, 1, 1], np.int32)
    got = DA.decode_attention_fwd(q, k, v, torch.from_numpy(none))
    want = np.asarray(ref_decode(jq, jk, jv, jnp.asarray(none)))
    assert np.array_equal(np.isnan(got.numpy()), np.isnan(want))
    got = got.numpy()
    assert np.isnan(got[0]).all() and not np.isnan(got[1]).any()


def test_decode_tail_tiles_add_nothing():
    """Tiles past a sequence's valid length leave its result bit-equal
    (the plain version walks them for a longer neighbour)."""
    (_, q), (_, k), (_, v) = _inputs(6, "float32", (2, 4, 16),
                                     (2, 256, 2, 16), (2, 256, 2, 16))
    both = DA.decode_attention_plain(q, k, v, torch.tensor([70, 256]))
    alone = DA.decode_attention_plain(q[:1], k[:1], v[:1],
                                      torch.tensor([70]))
    assert torch.equal(both[:1], alone)


# ---------------------------------------------------------------------------
# 3. The oracles
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d", FWD_SHAPES[:2] + FWD_SHAPES[3:])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_oracles_match_reference(b, sq, sk, hq, hkv, d, dtype):
    (jq, q), (jk, k), (jv, v) = _inputs(
        7, dtype, (b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d))
    np.testing.assert_allclose(
        _np(attention_reference(q, k, v, causal=True, window=40)),
        _np(ref_attention(jq, jk, jv, causal=True, window=40)),
        **_tol(dtype))
    out, lse = attention_reference_with_lse(q, k, v, causal=False)
    want, want_lse = ref_attention_lse(jq, jk, jv, causal=False)
    np.testing.assert_allclose(_np(out), _np(want), **_tol(dtype))
    np.testing.assert_allclose(_np(lse), _np(want_lse), rtol=2e-5,
                               atol=2e-5)
    valid = _valid(1, b, sk)
    np.testing.assert_allclose(
        _np(decode_attention_reference(q[:, 0], k, v,
                                       torch.from_numpy(valid))),
        _np(ref_decode(jq[:, 0], jk, jv, jnp.asarray(valid))),
        **_tol(dtype))


# ---------------------------------------------------------------------------
# 4. The ops
# ---------------------------------------------------------------------------
def test_ops_select_kernel_or_oracle():
    (_, q), (_, k), (_, v) = _inputs(8, "float32", (1, 70, 4, 16),
                                     (1, 70, 2, 16), (1, 70, 2, 16))
    kern = FOPS.flash_attention(q, k, v)
    ref = FOPS.flash_attention(q, k, v, impl="ref")
    assert torch.equal(kern, FA.flash_attention_fwd(q, k, v)[0])
    assert torch.equal(ref, attention_reference(q, k, v))
    torch.testing.assert_close(kern, ref, rtol=2e-5, atol=2e-5)
    # a valid length goes through the oracle, as in the reference
    valid = torch.tensor([33])
    assert torch.equal(
        FOPS.flash_attention(q, k, v, causal=False, kv_valid_len=valid),
        attention_reference(q, k, v, causal=False, kv_valid_len=valid))
    dq = q[:, 0].contiguous()
    assert torch.equal(DOPS.decode_attention(dq, k, v, valid),
                       DA.decode_attention_fwd(dq, k, v, valid))
    assert torch.equal(DOPS.decode_attention(dq, k, v, valid, impl="ref"),
                       decode_attention_reference(dq, k, v, valid))
    for bad in ("pallas", "auto"):
        with pytest.raises(ValueError, match="impl"):
            FOPS.flash_attention(q, k, v, impl=bad)
        with pytest.raises(ValueError, match="impl"):
            DOPS.decode_attention(dq, k, v, valid, impl=bad)


def test_plain_versions_launch_nothing():
    K.reset_launches()
    (_, q), (_, k), (_, v) = _inputs(9, "float32", (1, 8, 2, 16),
                                     (1, 8, 2, 16), (1, 8, 2, 16))
    FA.flash_attention_fwd(q, k, v)
    DA.decode_attention_fwd(q[:, 0].contiguous(), k, v, torch.tensor([8]))
    assert K.launches["flash_fwd"] == 0 and K.launches["decode"] == 0


def test_gradients_refused_off_the_cpu():
    """Off the CPU the gradient path is the kernels' (B6 forward, B7/B8
    backward, through ``FlashAttention``): a device they cannot run on
    raises, with or without a gradient wanted, instead of falling back."""
    q = torch.empty((1, 4, 2, 16), device="meta", requires_grad=True)
    k = torch.empty((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="devices"):
        FOPS.flash_attention(q, k, k)
    with torch.no_grad():     # no gradient wanted: the same dispatch
        with pytest.raises(ValueError, match="devices"):
            FOPS.flash_attention(q, k, k)
    # on the CPU the op runs the plain versions, forward and backward
    x = torch.randn(1, 8, 2, 16, requires_grad=True)
    FOPS.flash_attention(x, x, x).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_unported_paths_raise():
    (_, q), (_, k), (_, v) = _inputs(10, "float32", (1, 8, 2, 16),
                                     (1, 8, 2, 16), (1, 8, 2, 16))
    # the sequence-parallel decode is ported
    # (tests/test_torch_dist_decode.py): off a mesh it refuses to run
    with pytest.raises(ValueError, match="mesh"):
        DOPS.decode_attention(q[:, 0], k, v, torch.tensor([8]), impl="dist")
    # the backward kernels B7/B8 are ported: on the CPU their plain
    # versions give the gradients in the inputs' types
    out, lse = FA.flash_attention_fwd(q, k, v)
    grads = FA.flash_attention_bwd(q, k, v, out, lse, out)
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in grads)


def test_kernel_wrappers_check_arguments():
    """The launchers refuse what the kernels do not take, before anything
    is built (this host has no nvcc)."""
    meta = dict(device="meta")
    q = torch.empty((1, 8, 4, 16), **meta)
    with pytest.raises(TypeError, match="dtype"):
        K.launch_flash_fwd(q, q.half(), q, True, 0, 0.25)
    with pytest.raises(ValueError, match="head_dim"):
        x = torch.empty((1, 8, 4, 24), **meta)
        K.launch_flash_fwd(x, x, x, True, 0, 0.25)
    with pytest.raises(ValueError, match="contiguous"):
        K.launch_flash_fwd(q.transpose(1, 2).contiguous().transpose(1, 2),
                           q, q, True, 0, 0.25)
    dq = torch.empty((2, 65, 16), **meta)
    kv = torch.empty((2, 8, 1, 16), **meta)
    with pytest.raises(ValueError, match="group"):
        K.launch_decode(dq, kv, kv, torch.empty(2, dtype=torch.int32,
                                                **meta), 0.25)
    with pytest.raises(TypeError, match="int32"):
        K.launch_decode(torch.empty((2, 4, 16), **meta), kv, kv,
                        torch.empty(2, **meta), 0.25)


@pytest.mark.parametrize("hq,hkv,causal", [
    (4, 4, True), (4, 4, False),     # hubert-xlarge's layout is MHA
    (4, 2, False),                   # a GQA group of 2
])
def test_flash_bwd_plain_head_dim_80_matches_reference(hq, hkv, causal):
    """B7's and B8's plain versions at head_dim 80 (the SIMT bodies' tiles)
    against ``jax.grad`` through the reference's Pallas kernels in
    interpret mode (its ``custom_vjp``: ``_dkv_kernel``, ``_dq_kernel``)
    and through its oracle, float32, within the gradient tolerance of
    ``tests/test_kernels.py`` (1e-3)."""
    import jax

    from repro.kernels.flash_attention import ops as ROPS

    b, sq, sk, d = 1, 128, 128, 80
    assert not K.flash_bwd_tc(torch.float32, d)
    (jq, q), (jk, k), (jv, v), (jdo, do) = _inputs(
        80 + hkv, "float32", (b, sq, hq, d), (b, sk, hkv, d),
        (b, sk, hkv, d), (b, sq, hq, d))
    out, lse = FA.flash_attention_fwd(q, k, v, causal=causal)
    got = FA.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    assert [tuple(g.shape) for g in got] == [q.shape, k.shape, v.shape]
    for impl, tiles in (("pallas", dict(block_q=64, block_k=64)),
                        ("ref", {})):
        def loss(q_, k_, v_):
            o = ROPS.flash_attention(q_, k_, v_, causal=causal, impl=impl,
                                     **tiles)
            return jnp.sum(o * jdo)
        want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), _np(w), rtol=1e-3, atol=1e-3,
                                       err_msg=impl)


@pytest.mark.parametrize("b,sk,hq,hkv", [(3, 256, 4, 4), (2, 128, 8, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_head_dim_80_matches_reference(b, sk, hq, hkv, dtype):
    """B9's plain version at head_dim 80 (valid lengths at 1, at tile
    edges and at the cache size) against the reference's decode kernel
    in interpret mode and its oracle."""
    d = 80
    (jq, q), (jk, k), (jv, v) = _inputs(
        81, dtype, (b, hq, d), (b, sk, hkv, d), (b, sk, hkv, d))
    valid = _valid(b * sk, b, sk)
    out = DA.decode_attention_fwd(q, k, v, torch.from_numpy(valid))
    assert out.dtype == q.dtype and out.shape == q.shape
    want = ref_decode(jq, jk, jv, jnp.asarray(valid))
    pal = decode_attention_pallas(jq, jk, jv, jnp.asarray(valid),
                                  block_k=128, interpret=True)
    np.testing.assert_allclose(_np(out), _np(want), **_tol(dtype))
    np.testing.assert_allclose(_np(out), _np(pal), **_tol(dtype))


# ---------------------------------------------------------------------------
# 5. On the card (skips without one)
# ---------------------------------------------------------------------------
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")


def _on_card(pairs):
    return [t.cuda() for _j, t in pairs]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal,window", [
    (1, 128, 256, 2, 1, 32, True, 0),
    (2, 100, 130, 4, 1, 16, True, 0),
    (1, 77, 256, 8, 2, 64, False, 0),
    (1, 200, 300, 48, 1, 128, True, 64),
    (2, 130, 130, 32, 8, 128, True, 0),
    (1, 130, 200, 8, 2, 80, True, 0),
])
def test_flash_kernel_matches_plain_on_card(dtype, b, sq, sk, hq, hkv, d,
                                            causal, window):
    _need_card()
    q, k, v = _on_card(_inputs(11, dtype, (b, sq, hq, d), (b, sk, hkv, d),
                               (b, sk, hkv, d)))
    before = K.launches["flash_fwd"]
    out, lse = FA.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert K.launches["flash_fwd"] == before + 1
    pout, plse = FA.flash_attention_plain(q, k, v, causal=causal,
                                          window=window)
    torch.testing.assert_close(out.float(), pout.float(), **_tol(dtype))
    torch.testing.assert_close(lse, plse, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sk,hq,hkv,d", [(5, 4096, 32, 8, 128),
                                           (3, 300, 48, 1, 64),
                                           (2, 128, 4, 4, 16),
                                           (5, 300, 16, 8, 80)])
def test_decode_kernel_matches_plain_on_card(dtype, b, sk, hq, hkv, d):
    _need_card()
    q, k, v = _on_card(_inputs(12, dtype, (b, hq, d), (b, sk, hkv, d),
                               (b, sk, hkv, d)))
    valid = torch.from_numpy(_valid(13, b, sk)).cuda()
    before = K.launches["decode"]
    out = DA.decode_attention_fwd(q, k, v, valid)
    torch.cuda.synchronize()
    assert K.launches["decode"] == before + 1
    want = DA.decode_attention_plain(q, k, v, valid)
    torch.testing.assert_close(out.float(), want.float(), **_tol(dtype))


# The Hopper body (bf16 at head_dim 64/80/128) at its 128 x 128 tile edges.
TC_EDGE_CASES = [
    (1, 127, 127, 8, 2, 128, True, 0),     # one row and key short
    (1, 128, 128, 8, 2, 128, True, 0),     # exactly one tile
    (1, 129, 129, 8, 2, 128, True, 0),     # one row and key past it
    (1, 127, 129, 16, 16, 64, True, 0),    # the training layout
    (1, 129, 300, 48, 1, 128, True, 0),    # a group of 48, q_offset 171
    (2, 300, 300, 16, 4, 128, True, 0),    # a group of 4, ragged
    (1, 300, 300, 16, 16, 64, True, 100),  # a window crossing a tile
    (1, 77, 256, 32, 8, 128, False, 40),   # a window without the band
    # head_dim 80 (hubert-xlarge): five 16-column tiles a row
    (1, 127, 129, 16, 16, 80, False, 0),   # hubert's layout, ragged
    (1, 128, 128, 4, 4, 80, True, 0),      # exactly one tile
    (1, 129, 300, 8, 2, 80, True, 0),      # a group of 4, q_offset 171
    (2, 300, 300, 4, 4, 80, True, 100),    # a window crossing a tile
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal,window", TC_EDGE_CASES)
def test_flash_hopper_body_matches_plain_on_card(b, sq, sk, hq, hkv, d,
                                                 causal, window):
    _need_card()
    q, k, v = _on_card(_inputs(14, "bfloat16", (b, sq, hq, d),
                               (b, sk, hkv, d), (b, sk, hkv, d)))
    K.reset_launches()
    out, lse = FA.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert K.launches["flash_fwd"] == K.launches["flash_fwd_tc"] == 1
    pout, plse = FA.flash_attention_plain(q, k, v, causal=causal,
                                          window=window)
    torch.testing.assert_close(out.float(), pout.float(),
                               **_tol("bfloat16"))
    torch.testing.assert_close(lse, plse, rtol=2e-5, atol=2e-5)
    # no atomics, no split of the keys: the same inputs give the same bits
    again, again_lse = FA.flash_attention_fwd(q, k, v, causal=causal,
                                              window=window)
    assert torch.equal(out, again) and torch.equal(lse, again_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("float32", 64), ("float32", 128),
                                     ("bfloat16", 16), ("bfloat16", 32),
                                     ("float32", 80)])
def test_flash_simt_body_keeps_its_inputs_on_card(dtype, d):
    """float32 (any head_dim) and bf16 at head_dim 16/32 stay on the SIMT
    body: counted as ``flash_fwd`` only (bf16 at head_dim 80 runs the
    Hopper body: ``TC_EDGE_CASES``)."""
    _need_card()
    q, k, v = _on_card(_inputs(15, dtype, (1, 129, 4, d), (1, 129, 2, d),
                               (1, 129, 2, d)))
    K.reset_launches()
    out, lse = FA.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert K.launches["flash_fwd"] == 1 and K.launches["flash_fwd_tc"] == 0
    pout, plse = FA.flash_attention_plain(q, k, v)
    torch.testing.assert_close(out.float(), pout.float(), **_tol(dtype))
    torch.testing.assert_close(lse, plse, rtol=2e-5, atol=2e-5)
