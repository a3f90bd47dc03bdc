"""The Hopper bodies of the port's flash-attention backward (B7 and B8 for
bf16 inputs at head_dim 64, 80 and 128) against the reference package.

On the CPU, ``flash_attention_bwd`` runs B7's and B8's plain versions;
for these inputs they round p and dS to bf16 before the products that
take them (the tensor cores' operand type), as the Hopper bodies do, and
B7's plain version keeps each query head's partial sums apart and adds a
GQA group's in head order, as ``flash_dkv_group_sum`` does on the card.
Inputs are drawn with numpy from a seed and handed to both packages.

1. **Against the reference's Pallas backward** — its
   ``flash_attention_bwd`` in interpret mode, in this process, on the
   port's lse and the same bf16 dO: head_dim 64, groups 1, 4 and 8,
   sq < sk off the port's 64-row tiles (the reference runs 32-row tiles,
   which divide), a window, and not causal; head_dim 80 at hubert-xlarge's
   layout (16/16 heads, not causal), groups 2 and 8, sq < sk off the
   tiles and a window. Tolerance 2e-2 (relative and
   absolute): the reference keeps p and dS in float32, the port rounds
   each to bf16 (a relative error of at most 2^-9 in each term), and
   both outputs are bf16 (2^-9 again); the same limit holds the card's
   bf16 kernels to their plain versions (``chip_smoke.ATTN_TOL``).
2. **Tiles** — other tiles change the plain gradient only by summation
   order: within two bf16 units in the last place. So does the padded
   layout of head_dim 80 (zero columns up to 128, the head_dim-128
   products, the first 80 columns kept).
3. **Body choice and tiles** — ``flash_bwd_tc`` and the tile constants,
   and the load-time checks that hold the library to them.
4. **The group sum** — a reduction in head order equals the plain
   version's sum, bit for bit.
5. **On the card** (marked ``cuda``; skips without one) — each Hopper
   body against its plain version, two launches on the same inputs giving
   the same bits, and the group-sum kernel against its plain version.
"""
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as RFA
from repro_torch.accel import kernels as K
from repro_torch.kernels.flash_attention import flash_attention as FA

BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _bf16(*xs):
    return [torch.from_numpy(x).to(torch.bfloat16) for x in xs]


def _jnp(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _bwd(q, k, v, do, causal, window, **tiles):
    out, lse = FA.flash_attention_fwd(q, k, v, causal=causal, window=window)
    return FA.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                  window=window, **tiles), out, lse


# ---------------------------------------------------------------------------
# 1. Against the reference's Pallas backward (interpret mode)
# ---------------------------------------------------------------------------
# (d, hq, hkv, sq, sk, causal, window): head_dim 64 at each (hq, hkv) and
# (sq, sk, causal, window), then head_dim 80's cases
PALLAS_CASES = [
    pytest.param(64, hq, hkv, sq, sk, causal, window,
                 id=f"{sq}-{sk}-{causal}-{window}-{hq}-{hkv}")
    for sq, sk, causal, window in (
        (96, 160, True, 0),       # sq < sk (q_offset 64), off the 64-row tiles
        (128, 128, True, 40),     # a window
        (64, 96, False, 0))       # not causal
    for hq, hkv in ((4, 4), (4, 1), (8, 1))
] + [
    pytest.param(80, 16, 16, 128, 128, False, 0, id="d80-hubert"),
    pytest.param(80, 4, 2, 96, 160, True, 0, id="d80-group2-offset"),
    pytest.param(80, 8, 1, 96, 160, True, 0, id="d80-group8-offset"),
    pytest.param(80, 8, 1, 128, 128, True, 40, id="d80-group8-window"),
]


@pytest.mark.parametrize("d,hq,hkv,sq,sk,causal,window", PALLAS_CASES)
def test_tc_plain_bwd_matches_reference_pallas(d, hq, hkv, sq, sk, causal,
                                               window):
    b = 1
    assert K.flash_bwd_tc(torch.bfloat16, d)
    q, k, v, do = _bf16(*_arrays(hq * 7 + sq + window, (b, sq, hq, d),
                                 (b, sk, hkv, d), (b, sk, hkv, d),
                                 (b, sq, hq, d)))
    (dq, dk, dv), out, lse = _bwd(q, k, v, do, causal, window)
    rdq, rdk, rdv = RFA.flash_attention_bwd(
        _jnp(q), _jnp(k), _jnp(v), _jnp(out), jnp.asarray(lse.numpy()),
        _jnp(do), causal=causal, window=window, block_q=32, block_k=32,
        interpret=True)
    for got, want in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   **BF16_TOL)


def test_tc_plain_rounds_p_and_ds():
    """The rounding is what separates the two bodies' plain versions: the
    same bf16 inputs at head_dim 64 (rounded) and 32 (not) against the
    float32 reference, and the rounded dq is not the unrounded one."""
    q, k, v, do = _bf16(*_arrays(3, (1, 96, 4, 64), (1, 96, 2, 64),
                                 (1, 96, 2, 64), (1, 96, 4, 64)))
    out, lse = FA.flash_attention_fwd(q, k, v)
    args = (q, k, v, do, lse, FA.bwd_delta(out, do))
    rounded = FA.flash_attention_dq_plain(*args)
    # the same loop without the rounding: float32 inputs of the same values
    f32 = FA.flash_attention_dq_plain(*(x.float() for x in args))
    assert not torch.equal(rounded.float(), f32.to(torch.bfloat16).float())
    torch.testing.assert_close(rounded.float(), f32, **BF16_TOL)


# ---------------------------------------------------------------------------
# 2. Tiles change the gradient only by summation order
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d,hq,hkv", [(64, 4, 2), (128, 8, 1), (80, 16, 16),
                                     (80, 8, 1)])
def test_tc_tiles_do_not_change_the_gradient(d, hq, hkv):
    """The plain versions on the Hopper body's 64 x 64 pairs and on 32 x 16
    pairs: p and dS are rounded element by element, a skipped pair's p is
    all zero, so only the float32 sums' order differs — within two bf16
    units in the last place (2^-7 relative)."""
    q, k, v, do = _bf16(*_arrays(d + hq, (1, 96, hq, d), (1, 160, hkv, d),
                                 (1, 160, hkv, d), (1, 96, hq, d)))
    assert K.flash_bwd_tiles(torch.bfloat16, d) == (64, 64)
    a, _o, _l = _bwd(q, k, v, do, True, 50)
    b, _o, _l = _bwd(q, k, v, do, True, 50, block_q=32, block_k=16)
    for x, y in zip(a, b):
        torch.testing.assert_close(x.float(), y.float(), rtol=2 ** -7,
                                   atol=1e-4)


@pytest.mark.parametrize("hq,hkv,causal,window", [
    (16, 16, False, 0),       # hubert-xlarge's layout
    (8, 1, True, 40),         # a group of 8, a window
])
def test_tc_d80_equals_the_padded_layout(hq, hkv, causal, window):
    """Where ``flash_bwd_tc`` holds at head_dim 80, its plain gradient is
    the plain gradient of the same inputs zero-padded to head_dim 128 (the
    padded layout's products, at 80's scale, lse and delta) with the first
    80 columns kept: the zero columns add nothing to the scores, so only
    the float32 sums' order differs — within two bf16 units in the last
    place."""
    d, pad = 80, 128
    assert K.flash_bwd_tc(torch.bfloat16, d)
    assert K.flash_bwd_tc(torch.bfloat16, pad)
    q, k, v, do = _bf16(*_arrays(hq + window, (1, 96, hq, d), (1, 160, hkv, d),
                                 (1, 160, hkv, d), (1, 96, hq, d)))
    out, lse = FA.flash_attention_fwd(q, k, v, causal=causal, window=window)
    delta = FA.bwd_delta(out, do)
    opts = dict(causal=causal, window=window, scale=d ** -0.5)

    def padded(x):
        return torch.nn.functional.pad(x, (0, pad - d)).contiguous()

    wide = [padded(x) for x in (q, k, v, do)] + [lse, delta]
    narrow = (q, k, v, do, lse, delta)
    got = (FA.flash_attention_dq_plain(*narrow, **opts),
           *FA.flash_attention_dkv_plain(*narrow, **opts))
    want = (FA.flash_attention_dq_plain(*wide, **opts),
            *FA.flash_attention_dkv_plain(*wide, **opts))
    for x, y in zip(got, want):
        assert x.shape[-1] == d and y.shape[-1] == pad
        assert not y[..., d:].any()
        torch.testing.assert_close(x.float(), y[..., :d].float(),
                                   rtol=2 ** -7, atol=1e-4)


# ---------------------------------------------------------------------------
# 3. Body choice and tiles
# ---------------------------------------------------------------------------
def test_tc_body_choice_and_tiles():
    for d in K.HEAD_DIMS:
        assert K.flash_bwd_tc(torch.bfloat16, d) == (d in (64, 80, 128))
        assert not K.flash_bwd_tc(torch.float32, d)
        # B6 takes its Hopper body at the same head_dims
        assert K.flash_fwd_tc(torch.bfloat16, d) == (d in (64, 80, 128))
        want = (K.FLASH_BWD_TC_BLOCK_Q, K.FLASH_BWD_TC_BLOCK_K) \
            if d in (64, 80, 128) else (K.FLASH_BWD_BLOCK_Q,
                                        K.FLASH_BWD_BLOCK_K)
        assert K.flash_bwd_tiles(torch.bfloat16, d) == want
        assert K.flash_bwd_tiles(torch.float32, d) == (K.FLASH_BWD_BLOCK_Q,
                                                       K.FLASH_BWD_BLOCK_K)
    # the Hopper bodies' consumers pair 64 rows with streamed tiles of 64
    assert (K.FLASH_BWD_TC_BLOCK_Q, K.FLASH_BWD_TC_BLOCK_K) == (64, 64)
    # the plain versions walk the body's tiles by default
    q, k, v, do = _bf16(*_arrays(11, (1, 70, 2, 64), (1, 70, 2, 64),
                                 (1, 70, 2, 64), (1, 70, 2, 64)))
    out, lse = FA.flash_attention_fwd(q, k, v)
    args = (q, k, v, do, lse, FA.bwd_delta(out, do))
    tiles = dict(zip(("block_q", "block_k"),
                     K.flash_bwd_tiles(q.dtype, 64)))
    assert torch.equal(FA.flash_attention_dq_plain(*args),
                       FA.flash_attention_dq_plain(*args, **tiles))
    for x, y in zip(FA.flash_attention_dkv_plain(*args),
                    FA.flash_attention_dkv_plain(*args, **tiles)):
        assert torch.equal(x, y)


def _fake_bwd_library(**override):
    """A stand-in for the built library with the C entry points ``_bind``
    reads: the tiles and body choice the sources define."""
    fns = dict(
        flash_bwd_dq=lambda *a: 0, flash_bwd_dkv=lambda *a: 0,
        flash_bwd_group_sum=lambda *a: 0,
        flash_bwd_tc=lambda is_bf16, d: int(bool(is_bf16) and d in (64, 80,
                                                                    128)),
        flash_bwd_block_q=lambda: 64, flash_bwd_block_k=lambda: 64,
        flash_bwd_tc_block_q=lambda: 64, flash_bwd_tc_block_k=lambda: 64)
    fns.update(override)
    return types.SimpleNamespace(**fns)


def test_tc_library_checks_hold_the_wrappers():
    """Loading the library checks its tiles and its body choice against
    the wrappers' constants; a library that disagrees is refused."""
    K._bind("flash_bwd", _fake_bwd_library())
    with pytest.raises(RuntimeError, match="tile"):
        K._bind("flash_bwd", _fake_bwd_library(
            flash_bwd_tc_block_k=lambda: 128))
    with pytest.raises(RuntimeError, match="body"):
        K._bind("flash_bwd", _fake_bwd_library(
            flash_bwd_tc=lambda is_bf16, d: int(bool(is_bf16))))
    # a library whose Hopper bodies stop at 64/128 (an earlier build) is
    # refused
    with pytest.raises(RuntimeError, match="head_dim 80"):
        K._bind("flash_bwd", _fake_bwd_library(
            flash_bwd_tc=lambda is_bf16, d: int(bool(is_bf16) and d in (
                64, 128))))
    with pytest.raises(RuntimeError, match="body"):
        K.check_bodies("flash", lambda is_bf16, d: 0, K.flash_fwd_tc)
    # so is a B6 library whose Hopper body stops at 64/128
    with pytest.raises(RuntimeError, match="head_dim 80"):
        K.check_bodies("flash", lambda is_bf16, d: int(bool(is_bf16) and d in (
            64, 128)), K.flash_fwd_tc)


def test_group_sum_wrapper_checks_arguments():
    """The group-sum launcher refuses what its kernel does not take,
    before anything is built (this host has no nvcc)."""
    part = torch.empty((1, 8, 4, 64), device="meta")
    with pytest.raises(TypeError, match="float32"):
        K.launch_flash_dkv_group_sum(part.half(), part, 2)
    with pytest.raises(ValueError, match="shape"):
        K.launch_flash_dkv_group_sum(part, part[:, :4], 2)
    with pytest.raises(ValueError, match="heads"):
        K.launch_flash_dkv_group_sum(part, part, 3)


# ---------------------------------------------------------------------------
# 4. The group sum
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hq,hkv", [(4, 1), (8, 2), (3, 3)])
def test_group_sum_plain_adds_in_head_order(hq, hkv):
    """KV head hk's sum is ((p[hk G] + p[hk G + 1]) + ...) in float32,
    then cast: bit for bit."""
    dk_part, dv_part = (torch.from_numpy(x) for x in _arrays(
        hq, (2, 5, hq, 8), (2, 5, hq, 8)))
    group = hq // hkv
    for dtype in (torch.float32, torch.bfloat16):
        dk, dv = FA.dkv_group_sum_plain(dk_part, dv_part, hkv, dtype)
        for got, part in ((dk, dk_part), (dv, dv_part)):
            assert got.shape == (2, 5, hkv, 8) and got.dtype == dtype
            for hk in range(hkv):
                want = functools.reduce(torch.add, [
                    part[:, :, hk * group + g] for g in range(group)])
                assert torch.equal(got[:, :, hk], want.to(dtype))


def test_tc_dkv_plain_sums_each_head_then_the_group(monkeypatch):
    """B7's plain version for the Hopper body's inputs keeps one f32
    partial per query head, as the kernel's blocks write them, and its
    result is the head-order group sum of those partials; each head's
    partial is its own gradient (the group-1 plain version on that head
    alone, to bf16 rounding)."""
    hq, hkv, d = 4, 1, 64
    q, k, v, do = _bf16(*_arrays(21, (1, 80, hq, d), (1, 100, hkv, d),
                                 (1, 100, hkv, d), (1, 80, hq, d)))
    out, lse = FA.flash_attention_fwd(q, k, v)
    delta = FA.bwd_delta(out, do)
    seen = []
    orig = FA.dkv_group_sum_plain
    monkeypatch.setattr(FA, "dkv_group_sum_plain", lambda *a, **kw:
                        seen.append(a) or orig(*a, **kw))
    dk, dv = FA.flash_attention_dkv_plain(q, k, v, do, lse, delta)
    (dk_part, dv_part, n_kv, dtype), = seen
    assert dk_part.shape == (1, 100, hq, d) and dk_part.dtype == torch.float32
    assert n_kv == hkv and dtype == torch.bfloat16
    want = orig(dk_part, dv_part, hkv)
    assert torch.equal(dk, want[0]) and torch.equal(dv, want[1])
    for h in range(hq):
        sl = slice(h, h + 1)
        hdk, hdv = orig(*(x[:, :, sl].contiguous() for x in
                          (dk_part, dv_part)), 1)
        one = FA.flash_attention_dkv_plain(
            q[:, :, sl].contiguous(), k, v, do[:, :, sl].contiguous(),
            lse[:, sl].contiguous(), delta[:, sl].contiguous())
        assert torch.equal(one[0], hdk) and torch.equal(one[1], hdv)


# ---------------------------------------------------------------------------
# 5. On the card (skips without one)
# ---------------------------------------------------------------------------
TC_CASES = [
    (1, 100, 300, 4, 1, 64, True, 0),      # sq < sk, ragged, a group of 4
    (2, 130, 130, 8, 8, 128, True, 0),     # group 1, off the 128-row blocks
    (1, 200, 300, 16, 2, 128, True, 64),   # a group of 8, a window
    (2, 64, 64, 4, 4, 64, False, 0),       # not causal, one block
    (1, 77, 256, 32, 8, 128, False, 40),   # a window without the band
    (1, 129, 129, 8, 2, 64, True, 0),      # one row and key past a block
    # head_dim 80: five 16-column tiles
    (2, 130, 130, 16, 16, 80, False, 0),   # hubert-xlarge's layout, ragged
    (1, 200, 300, 16, 2, 80, True, 64),    # a group of 8, a window
    (1, 77, 256, 8, 8, 80, False, 40),     # a window without the band
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal,window", TC_CASES)
def test_tc_kernels_match_plain_on_card(b, sq, sk, hq, hkv, d, causal,
                                        window):
    """Each Hopper body against its plain version within 2e-2, every
    launch counted on the new bodies, the group sum launched once where
    the group is above 1, and the same bits from a second launch."""
    _card()
    q, k, v, do = (x.cuda() for x in _bf16(*_arrays(
        sq + d + hq, (b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d),
        (b, sq, hq, d))))
    out, lse = FA.flash_attention_fwd(q, k, v, causal=causal, window=window)
    args = (q, k, v, do, lse, FA.bwd_delta(out, do))
    K.reset_launches()
    got = FA.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                 window=window)
    torch.cuda.synchronize()
    split = int(hq != hkv)
    assert {key: K.launches[key] for key in (
        "flash_dkv", "flash_dkv_tc", "flash_dq", "flash_dq_tc",
        "flash_dkv_group_sum")} == dict(
            flash_dkv=1, flash_dkv_tc=1, flash_dq=1, flash_dq_tc=1,
            flash_dkv_group_sum=split)
    again = FA.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                   window=window)
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    pdk, pdv = FA.flash_attention_dkv_plain(*args, causal=causal,
                                            window=window)
    pdq = FA.flash_attention_dq_plain(*args, causal=causal, window=window)
    for g, w in zip(got, (pdq, pdk, pdv)):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w.float(), **BF16_TOL)


@pytest.mark.cuda
def test_group_sum_kernel_matches_plain_on_card():
    """The group-sum kernel adds in head order as its plain version:
    the same bits."""
    _card()
    dk_part, dv_part = (torch.from_numpy(x).cuda() for x in _arrays(
        8, (2, 300, 32, 128), (2, 300, 32, 128)))
    K.reset_launches()
    got = K.launch_flash_dkv_group_sum(dk_part, dv_part, 8)
    torch.cuda.synchronize()
    assert K.launches["flash_dkv_group_sum"] == 1
    for g, w in zip(got, FA.dkv_group_sum_plain(dk_part, dv_part, 8)):
        assert torch.equal(g, w)
