"""The port's flash-attention backward (kernels B7 and B8) against the
reference package.

Inputs are drawn with numpy from a seed and handed to both packages. On
the CPU, ``flash_attention_bwd`` runs B7's and B8's plain versions
(``flash_attention_dkv_plain``, ``flash_attention_dq_plain``): the loops
over (query tile, KV tile) pairs the CUDA kernels run, with the reference
kernels' skips, masks and float32 arithmetic.

1. **Against the reference's Pallas backward** — its ``flash_attention_bwd``
   in interpret mode, in this process (as ``tests/test_kernels.py:66-92``
   runs it), on the port's lse and the same dO: query/KV heads (2, 2),
   (4, 2), (4, 1), causal and not, a window, sq < sk, at shapes the
   reference's grid divides; within 1e-3 (``tests/test_kernels.py``'s
   gradient tolerance).
2. **Against autograd of the oracle** — dq, dk, dv of the plain versions
   against ``torch.autograd.grad`` through ``attention_reference`` at
   ragged shapes the reference cannot take, groups 1, 4 and 8, within
   1e-3; in bf16 within 2e-2 of the f32 oracle's gradient of the same
   bf16 values.
3. **The op** — ``FlashAttention`` (the ``autograd.Function``) against
   ``impl="ref"`` autograd; its dtypes; the tiles do not change the
   gradient; the forward on 128 x 128 tiles (B6's Hopper body's) and the
   backward on 64 x 64 give the oracle's out and gradients; nothing
   launches on the CPU.
4. **Launch counts** — several threads counting through
   ``count_launch`` lose no count.
5. **On the card** (marked ``cuda``; skips without one) — B7 and B8
   against their plain versions.
"""
import os
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as RFA
from repro_torch.accel import kernels as K
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.flash_attention import ops as FOPS
from repro_torch.kernels.flash_attention.ref import attention_reference

GRAD_TOL = dict(rtol=1e-3, atol=1e-3)     # tests/test_kernels.py:83-90


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype)


def _oracle_grads(q, k, v, do, causal, window):
    leaves = [x.detach().float().requires_grad_() for x in (q, k, v)]
    out = attention_reference(*leaves, causal=causal, window=window)
    return torch.autograd.grad(out, leaves, do.float())


def _bwd(q, k, v, do, causal, window, **tiles):
    out, lse = FA.flash_attention_fwd(q, k, v, causal=causal,
                                      window=window, **tiles)
    return FA.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                  window=window, **tiles), out, lse


# ---------------------------------------------------------------------------
# 1. Against the reference's Pallas backward (interpret mode)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2), (4, 1)])
@pytest.mark.parametrize("sq,sk,causal,window", [
    (128, 128, True, 0),
    (128, 128, False, 0),
    (128, 128, True, 48),
    (64, 128, True, 0),       # sq < sk: rows offset by 64
])
def test_plain_bwd_matches_reference_pallas(hq, hkv, sq, sk, causal,
                                            window):
    b, d = 1, 32
    q, k, v, do = _arrays(hq * 10 + sq + window, (b, sq, hq, d),
                          (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, hq, d))
    (dq, dk, dv), out, lse = _bwd(_t(q), _t(k), _t(v), _t(do), causal,
                                  window)
    rdq, rdk, rdv = RFA.flash_attention_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(out.numpy()), jnp.asarray(lse.numpy()), jnp.asarray(do),
        causal=causal, window=window, block_q=64, block_k=64,
        interpret=True)
    for got, want in ((dq, rdq), (dk, rdk), (dv, rdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **GRAD_TOL)


# ---------------------------------------------------------------------------
# 2. Against autograd of the oracle, at ragged shapes
# ---------------------------------------------------------------------------
RAGGED = [
    (1, 100, 300, 4, 1, 16, True, 0),      # sq < sk, a group of 4
    (2, 130, 130, 2, 2, 32, True, 0),      # group 1, off the tile
    (1, 90, 150, 8, 1, 16, True, 40),      # a group of 8, a window
    (1, 77, 77, 4, 4, 16, False, 0),       # not causal
    (1, 50, 200, 4, 2, 16, False, 30),     # a window without the band
]


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal,window", RAGGED)
def test_plain_bwd_matches_oracle_autograd(b, sq, sk, hq, hkv, d, causal,
                                           window):
    q, k, v, do = (_t(x) for x in _arrays(
        sq + sk + hq, (b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d),
        (b, sq, hq, d)))
    got, _out, _lse = _bwd(q, k, v, do, causal, window)
    for g, w in zip(got, _oracle_grads(q, k, v, do, causal, window)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD_TOL)


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal,window", RAGGED[:3])
def test_plain_bwd_bf16(b, sq, sk, hq, hkv, d, causal, window):
    """bf16 in, bf16 out (dq in q's type, dk/dv in k's/v's), within 2e-2
    of the f32 oracle's gradient of the same bf16 values."""
    q, k, v, do = (_t(x, torch.bfloat16) for x in _arrays(
        sq + 1, (b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d),
        (b, sq, hq, d)))
    got, _out, _lse = _bwd(q, k, v, do, causal, window)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3
    for g, w in zip(got, _oracle_grads(q, k, v, do, causal, window)):
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), rtol=2e-2,
                                   atol=2e-2)


def test_tiles_do_not_change_the_gradient():
    """A skipped tile pair's p is all zero: the plain versions give the
    same gradient on other tiles (to float32 rounding)."""
    q, k, v, do = (_t(x) for x in _arrays(
        5, (1, 96, 4, 16), (1, 160, 2, 16), (1, 160, 2, 16),
        (1, 96, 4, 16)))
    a, _o, _l = _bwd(q, k, v, do, True, 50)
    b, _o, _l = _bwd(q, k, v, do, True, 50, block_q=32, block_k=16)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# 3. The op
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hq,hkv,window", [(4, 4, 0), (8, 2, 0), (4, 1, 24)])
def test_op_gradient_matches_ref_impl(hq, hkv, window):
    """``FlashAttention`` (B6 forward, B7/B8 backward; plain versions on
    the CPU) against autograd through ``impl="ref"``."""
    q, k, v, do = _arrays(hq + window, (2, 70, hq, 16), (2, 70, hkv, 16),
                          (2, 70, hkv, 16), (2, 70, hq, 16))
    grads = []
    for impl in ("kernel", "ref"):
        leaves = [_t(x).requires_grad_() for x in (q, k, v)]
        out = FOPS.flash_attention(*leaves, window=window, impl=impl)
        grads.append(torch.autograd.grad(out, leaves, _t(do)))
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype,d,fwd_tiles", [
    ("float32", 64, dict(block_q=128, block_k=128)),
    ("bfloat16", 64, {}),      # the Hopper body's inputs: 128 x 128 tiles
    ("bfloat16", 128, {}),
])
def test_op_split_tiles_match_oracle(dtype, d, fwd_tiles):
    """``FlashAttention`` with the forward on 128 x 128 tiles and the
    backward on 64 x 64 (B7/B8 read the forward's lse, the same function
    on either tiles) gives the oracle's out and gradients: f32 within
    2e-5 and 1e-3, bf16 within 2e-2 of the f32 oracle on the same bf16
    values."""
    tdt = getattr(torch, dtype)
    q, k, v, do = (_t(x, tdt) for x in _arrays(
        d + 3, (1, 200, 4, d), (1, 200, 2, d), (1, 200, 2, d),
        (1, 200, 4, d)))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = FOPS.flash_attention(*leaves, window=150, **fwd_tiles)
    got = torch.autograd.grad(out, leaves, do)
    assert (FA.BWD_BLOCK_Q, FA.BWD_BLOCK_K) == (64, 64)
    ref_leaves = [x.detach().float().requires_grad_() for x in (q, k, v)]
    want_out = attention_reference(*ref_leaves, window=150)
    want = torch.autograd.grad(want_out, ref_leaves, do.float())
    out_tol = dict(rtol=2e-5, atol=2e-5) if dtype == "float32" \
        else dict(rtol=2e-2, atol=2e-2)
    grad_tol = GRAD_TOL if dtype == "float32" else dict(rtol=2e-2,
                                                        atol=2e-2)
    torch.testing.assert_close(out.float(), want_out.detach(), **out_tol)
    for g, w in zip(got, want):
        assert g.dtype == tdt
        torch.testing.assert_close(g.float(), w, **grad_tol)


def test_op_backward_runs_the_plain_versions_on_cpu(monkeypatch):
    calls = []
    for name in ("flash_attention_dkv_plain", "flash_attention_dq_plain"):
        orig = getattr(FA, name)
        monkeypatch.setattr(FA, name, lambda *a, _o=orig, _n=name, **kw:
                            calls.append(_n) or _o(*a, **kw))
    K.reset_launches()
    q = torch.randn(1, 20, 2, 16, requires_grad=True)
    FOPS.flash_attention(q, q, q).sum().backward()
    assert calls == ["flash_attention_dkv_plain", "flash_attention_dq_plain"]
    assert K.launches["flash_dkv"] == K.launches["flash_dq"] == 0
    assert torch.isfinite(q.grad).all()


def test_bwd_wrappers_check_arguments():
    """The B7/B8 launchers refuse what the kernels do not take, before
    anything is built (this host has no nvcc)."""
    meta = dict(device="meta")
    q = torch.empty((1, 8, 4, 16), **meta)
    st = torch.empty((1, 4, 8), **meta)
    with pytest.raises(TypeError, match="dtype"):
        K.launch_flash_dkv(q, q.half(), q, q, st, st, True, 0, 0.25)
    with pytest.raises(ValueError, match="head_dim"):
        x = torch.empty((1, 8, 4, 24), **meta)
        K.launch_flash_dq(x, x, x, x, st, st, True, 0, 0.25)
    with pytest.raises(TypeError, match="float32"):
        K.launch_flash_dq(q, q, q, q, st.half(), st, True, 0, 0.25)
    with pytest.raises(ValueError, match="shape"):
        K.launch_flash_dkv(q, q, q, q[:, :4], st, st, True, 0, 0.25)
    # a CUDA-like device never reaches the plain versions: no fallback
    with pytest.raises(ValueError, match="devices"):
        FA.flash_attention_bwd(q, q, q, q, st, q)


# ---------------------------------------------------------------------------
# 4. Launch counts across threads
# ---------------------------------------------------------------------------
def test_launch_counts_are_thread_safe():
    """More threads than cores count through ``count_launch`` with the
    interpreter switching threads every microsecond: no count is lost."""
    K.reset_launches()
    n_threads, per_thread = 2 * (os.cpu_count() or 4), 5000
    barrier = threading.Barrier(n_threads)

    def work():
        barrier.wait()
        for _ in range(per_thread):
            K.count_launch("flash_dq")

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert K.launches["flash_dq"] == n_threads * per_thread
    K.reset_launches()
    assert not any(K.launches.values())


# ---------------------------------------------------------------------------
# 5. On the card (skips without one)
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal,window", [
    (1, 100, 300, 4, 1, 64, True, 0),
    (2, 130, 130, 8, 8, 128, True, 0),
    (1, 200, 300, 16, 2, 128, True, 64),
    (1, 77, 256, 32, 8, 128, False, 40),
    (2, 130, 130, 16, 16, 80, False, 0),    # hubert-xlarge's head_dim
    (1, 100, 300, 4, 2, 80, True, 40),
])
def test_bwd_kernels_match_plain_on_card(dtype, b, sq, sk, hq, hkv, d,
                                         causal, window):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    tdt = getattr(torch, dtype)
    q, k, v, do = (_t(x, tdt).cuda() for x in _arrays(
        sq + d, (b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d),
        (b, sq, hq, d)))
    out, lse = FA.flash_attention_fwd(q, k, v, causal=causal, window=window)
    args = (q, k, v, do, lse, FA.bwd_delta(out, do))
    K.reset_launches()
    dq, dk, dv = FA.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                        window=window)
    torch.cuda.synchronize()
    assert K.launches["flash_dkv"] == K.launches["flash_dq"] == 1
    pdk, pdv = FA.flash_attention_dkv_plain(*args, causal=causal,
                                            window=window)
    pdq = FA.flash_attention_dq_plain(*args, causal=causal, window=window)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for got, want in ((dq, pdq), (dk, pdk), (dv, pdv)):
        assert got.dtype == tdt
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
