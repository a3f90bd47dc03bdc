"""B9's split-KV body (FlashDecoding) against the reference package.

On the CPU ``decode_attention_fwd`` runs ``decode_attention_plain``, which
follows the CUDA kernel's splits of ``DECODE_SPLIT`` = 128 keys (one block
each), its tiles of ``DECODE_BLOCK_K`` = 32 keys within a split and its
combine of the live splits in split order. Inputs are drawn with numpy
from a seed and handed to both packages.

1. **Against the reference** — the reference's
   ``decode_attention_pallas`` in interpret mode (in this process) and its
   oracle, at the reference kernels' tolerances (``tests/test_kernels.py``:
   bf16 2e-2, float32 2e-5, relative and absolute): valid lengths at the
   split edges (one key short of, at and one past one and two splits), at
   1 and past the cache
   (valid > S reads the whole cache), in one batch that mixes short and
   full sequences; groups 1, 4 and 48; head_dim 64 and 128.
2. **Empty splits** — a split that holds no valid key adds nothing: the
   same bits with the cache cut after the live splits, and a short
   sequence's result bit-equal beside a full one or alone; only a
   sequence with no key at all gives NaN.
3. **Splits and tiles** — other splits and tiles change the result only by
   float32 summation order (1e-5 of the output's scale).
4. **Constants** — the split, tile, stages and group limit the wrappers
   mirror (B9 has one body, for every dtype and head_dim), the library's
   checks of them, the scratch the launcher sizes from S alone, the
   launcher's argument checks.
5. **On the card** (marked ``cuda``; skips without one) — the split and
   combine kernels against the plain version, two launches giving the
   same bits, each counted once per call.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.decode_attention import (
    decode_attention_pallas)
from repro.kernels.decode_attention.ref import (
    decode_attention_reference as ref_decode)
from repro_torch.accel import kernels as K
from repro_torch.kernels.decode_attention import decode_attention as DA

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SPLIT = K.DECODE_SPLIT


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
# 1. Against the reference
# ---------------------------------------------------------------------------
S = 704   # six splits, the last one half full; a multiple of Pallas's 64
# split edges, valid 1 and past the cache, full and short in one batch
VALID = np.array([1, SPLIT - 1, SPLIT, SPLIT + 1, 2 * SPLIT - 1, 2 * SPLIT,
                  2 * SPLIT + 1, S + 9], np.int32)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (48, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_plain_matches_reference(dtype, hq, hkv, d):
    b = len(VALID)
    (jq, q), (jk, k), (jv, v) = _inputs(hq + d, dtype, (b, hq, d),
                                        (b, S, hkv, d), (b, S, hkv, d))
    assert K.decode_splits(S) == 6
    out = DA.decode_attention_fwd(q, k, v, torch.from_numpy(VALID))
    assert out.dtype == q.dtype and out.shape == q.shape
    valid = jnp.asarray(VALID)
    np.testing.assert_allclose(_np(out), _np(ref_decode(jq, jk, jv, valid)),
                               **_tol(dtype))
    pal = decode_attention_pallas(jq, jk, jv, valid, block_k=64,
                                  interpret=True)
    np.testing.assert_allclose(_np(out), _np(pal), **_tol(dtype))


def test_split_plain_reads_the_whole_cache_past_s():
    """valid > S is valid = S, as the reference's mask makes it."""
    (_, q), (_, k), (_, v) = _inputs(3, "float32", (2, 8, 32),
                                     (2, 300, 2, 32), (2, 300, 2, 32))
    past = DA.decode_attention_plain(q, k, v, torch.tensor([301, 5000]))
    at = DA.decode_attention_plain(q, k, v, torch.tensor([300, 300]))
    assert torch.equal(past, at)


# ---------------------------------------------------------------------------
# 2. Empty splits add nothing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_empty_splits_add_nothing(dtype):
    """Splits past every valid length leave the result bit-equal to a
    cache cut after the live splits; a short sequence beside a full one
    gives the bits it gives alone."""
    (_, q), (_, k), (_, v) = _inputs(4, dtype, (3, 8, 64), (3, 1024, 2, 64),
                                     (3, 1024, 2, 64))
    valid = torch.tensor([70, 300, 511])
    whole = DA.decode_attention_plain(q, k, v, valid)
    cut = DA.decode_attention_plain(q, k[:, :512].contiguous(),
                                    v[:, :512].contiguous(), valid)
    assert torch.equal(whole, cut)
    both = DA.decode_attention_plain(q[:2], k[:2], v[:2],
                                     torch.tensor([70, 1024]))
    alone = DA.decode_attention_plain(q[:1], k[:1], v[:1],
                                      torch.tensor([70]))
    assert torch.equal(both[:1], alone)
    assert torch.equal(whole[:1], alone)


def test_only_a_sequence_without_keys_is_nan():
    (jq, q), (jk, k), (jv, v) = _inputs(5, "float32", (4, 4, 32),
                                        (4, 600, 2, 32), (4, 600, 2, 32))
    valid = np.array([0, 257, -3, 600], np.int32)
    out = DA.decode_attention_fwd(q, k, v, torch.from_numpy(valid))
    want = np.asarray(ref_decode(jq, jk, jv, jnp.asarray(valid)))
    assert np.array_equal(np.isnan(out.numpy()), np.isnan(want))
    assert np.isnan(out[0].numpy()).all() and np.isnan(out[2].numpy()).all()
    assert not np.isnan(out[1].numpy()).any()
    np.testing.assert_allclose(out[[1, 3]].numpy(), want[[1, 3]], rtol=2e-5,
                               atol=2e-5)
    alone = DA.decode_attention_plain(q[1:2], k[1:2], v[1:2],
                                      torch.tensor([257]))
    assert torch.equal(out[1:2], alone)


# ---------------------------------------------------------------------------
# 3. Splits and tiles change only the summation order
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("split,block_k", [(512, 32), (128, 64), (64, 16)])
def test_splits_and_tiles_change_only_the_order(split, block_k):
    (_, q), (_, k), (_, v) = _inputs(6, "float32", (3, 8, 64),
                                     (3, 700, 2, 64), (3, 700, 2, 64))
    valid = torch.tensor([129, 513, 700])
    base = DA.decode_attention_plain(q, k, v, valid)
    other = DA.decode_attention_plain(q, k, v, valid, split=split,
                                      block_k=block_k)
    torch.testing.assert_close(other, base, rtol=1e-5,
                               atol=1e-5 * float(base.abs().max()))


def test_split_must_hold_whole_tiles():
    (_, q), (_, k), (_, v) = _inputs(7, "float32", (1, 2, 16),
                                     (1, 64, 1, 16), (1, 64, 1, 16))
    with pytest.raises(ValueError, match="multiple of the tile"):
        DA.decode_attention_plain(q, k, v, torch.tensor([10]), split=48)


# ---------------------------------------------------------------------------
# 4. Constants, the library's checks, the launcher
# ---------------------------------------------------------------------------
def test_constants_and_body():
    assert (K.DECODE_SPLIT, K.DECODE_BLOCK_K, K.DECODE_STAGES,
            K.DECODE_MAX_GROUP) == (128, 32, 3, 64)
    assert DA.SPLIT == K.DECODE_SPLIT and DA.BLOCK_K == K.DECODE_BLOCK_K
    assert K.DECODE_SPLIT % K.DECODE_BLOCK_K == 0
    # at most STAGES - 1 tiles ahead of the one computed: a split holds
    # more tiles than the ring, so the ring turns over
    assert K.DECODE_SPLIT // K.DECODE_BLOCK_K > K.DECODE_STAGES
    for S_, want in ((1, 1), (128, 1), (129, 2), (4096, 32), (4097, 33)):
        assert K.decode_splits(S_) == want


def _fake_decode_library(**override):
    """A stand-in for the built library with the C entry points ``_bind``
    reads: the constants the source defines."""
    fns = dict(decode_attn=lambda *a: 0, decode_attn_lse=lambda *a: 0,
               decode_block_k=lambda: 32, decode_split=lambda: 128,
               decode_stages=lambda: 3, decode_max_group=lambda: 64)
    fns.update(override)
    return types.SimpleNamespace(**fns)


def test_library_checks_hold_the_wrappers():
    K._bind("decode", _fake_decode_library())
    for name, value in (("decode_split", 256), ("decode_stages", 4),
                        ("decode_block_k", 64)):
        with pytest.raises(RuntimeError, match="tile"):
            K._bind("decode", _fake_decode_library(**{name: lambda: value}))


def test_launcher_checks_arguments():
    """The launcher refuses what the kernels do not take, before anything
    is built (this host has no nvcc)."""
    meta = dict(device="meta")
    q = torch.empty((2, 8, 64), **meta)
    kv = torch.empty((2, 300, 2, 64), **meta)
    valid = torch.empty(2, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="S 0"):
        K.launch_decode(q, kv[:, :0], kv[:, :0], valid, 0.125)
    with pytest.raises(ValueError, match="head_dim"):
        kv96 = torch.empty((2, 300, 2, 96), **meta)
        K.launch_decode(torch.empty((2, 8, 96), **meta), kv96, kv96, valid,
                        0.1)
    with pytest.raises(TypeError, match="dtype"):
        K.launch_decode(q, kv.to(torch.bfloat16), kv, valid, 0.125)
    with pytest.raises(ValueError, match="shape"):
        K.launch_decode(q, kv, kv, valid[:1], 0.125)


# ---------------------------------------------------------------------------
# 5. On the card (skips without one)
# ---------------------------------------------------------------------------
CARD_CASES = [
    ("bfloat16", 4, 4096, 32, 8, 128, (1, 255, 2100, 4096)),  # serving
    ("bfloat16", 3, 640, 48, 1, 128, (129, 512, 700)),        # group 48
    ("float32", 5, 600, 4, 4, 64, (1, 128, 129, 511, 600)),   # group 1
    ("float32", 2, 300, 8, 2, 16, (33, 300)),                 # d 16
    ("bfloat16", 3, 513, 16, 4, 32, (0, 512, 513)),           # no key
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,S_,hq,hkv,d,valid", CARD_CASES)
def test_split_kernels_match_plain_on_card(dtype, b, S_, hq, hkv, d, valid):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    q, k, v = (t.cuda() for _j, t in _inputs(
        S_ + d, dtype, (b, hq, d), (b, S_, hkv, d), (b, S_, hkv, d)))
    vl = torch.tensor(valid, dtype=torch.int32, device="cuda")
    K.reset_launches()
    out = DA.decode_attention_fwd(q, k, v, vl)
    torch.cuda.synchronize()
    assert (K.launches["decode"], K.launches["decode_combine"]) == (1, 1)
    again = DA.decode_attention_fwd(q, k, v, vl)
    assert torch.equal(out.view(torch.uint8), again.view(torch.uint8))
    want = DA.decode_attention_plain(q, k, v, vl)
    torch.testing.assert_close(out.float(), want.float(), equal_nan=True,
                               **_tol(dtype))
