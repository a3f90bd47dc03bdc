"""The port's SSD chunked scan (B10) against the reference package.

Inputs are drawn with numpy from a seed and handed to both packages. On
the CPU the port's ``ssd_fwd`` runs its plain torch version,
``ssd_plain``, which walks the chunks as the CUDA kernel does.

1. **Oracle** — the port's ``ref.ssd_reference`` against the reference's
   on the cases of ``tests/test_kernels.py:141-144``, a ragged sequence,
   two groups and a carried-in initial state, within 2e-4 (y and state);
   ``ssd_decode_step`` against the reference's.
2. **B10's plain version** — against the reference's Pallas kernel
   (``ssd_pallas``, interpret mode, in-process) in float32 within 2e-4
   and with bf16 inputs within 2e-2 (y; the state is float32 either way),
   and against the oracle where the Pallas kernel cannot go (s < chunk,
   a ragged tail, 8 groups, decay underflow).
3. **The recurrence** — the chunked dual form equals the naive per-token
   recurrence (``tests/test_kernels.py::test_ssd_sequential_recurrence
   _oracle``), for the oracle and the plain version.
4. **Ops** — ``impl`` dispatch (``"kernel"`` on the CPU is the plain
   version with no launch, ``"ref"`` the oracle, anything else raises),
   devices the kernel cannot run on refused (no fallback), the
   ``SSDFunction`` gradient against ``jax.vjp`` of the reference within
   1e-4, the launcher's argument checks.
5. **On the card** (marked ``cuda``; they skip without one) — B10 against
   its plain version, y and final state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ref import ssd_decode_step as ref_decode_step
from repro.kernels.ssd.ref import ssd_reference as ref_ssd
from repro.kernels.ssd.ssd import ssd_pallas
from repro_torch.accel import kernels as K
from repro_torch.kernels.ssd import ops as SOPS
from repro_torch.kernels.ssd import ssd as SSD
from repro_torch.kernels.ssd.ref import ssd_decode_step, ssd_reference

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
F32_TOL = dict(rtol=2e-4, atol=2e-4)     # tests/test_kernels.py:157-160
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _inputs(seed, b, s, h, p, g, n, dtype="float32", a_scale=None,
            dt_shift=0.0):
    """(jax, torch) pairs of x, dt, A, B, C, D: x, B, C ~ N(0, 1) in
    ``dtype``; dt = softplus(N(0, 1) + dt_shift) and A = -exp(N(0, .5)) (or
    ``-a_scale``), D ~ N(0, 1), all float32."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
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
    typed = {"x", "B", "C"}
    out = []
    for name, v in zip("x dt A B C D".split(), (x, dt, A, B, C, D)):
        jt, tt = (jdt, tdt) if name in typed else (jnp.float32,
                                                   torch.float32)
        out.append((jnp.asarray(v, jt), torch.from_numpy(v).to(tt)))
    return out


def _j(pairs):
    return [j for j, _t in pairs]


def _t(pairs):
    return [t for _j, t in pairs]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


# (b, s, h, p, g, n, chunk)
KERNEL_CASES = [(1, 128, 2, 16, 1, 16, 32),     # tests/test_kernels.py:141
                (2, 256, 4, 32, 1, 32, 64),
                (1, 64, 1, 64, 1, 16, 64)]      # single chunk
MORE_CASES = [(2, 100, 4, 16, 2, 16, 32),       # ragged tail, 2 groups
              (1, 40, 8, 16, 8, 32, 64),        # s < chunk, 8 groups
              (1, 130, 4, 64, 1, 128, 64)]      # p 64, n 128, ragged


# ---------------------------------------------------------------------------
# 1. The oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", KERNEL_CASES + MORE_CASES, ids=str)
def test_oracle_matches_reference(case):
    b, s, h, p, g, n, chunk = case
    pairs = _inputs(1, b, s, h, p, g, n)
    want_y, want_s = ref_ssd(*_j(pairs), chunk=chunk)
    y, st = ssd_reference(*_t(pairs), chunk=chunk)
    _close(y, want_y, F32_TOL)
    _close(st, want_s, F32_TOL)


def test_oracle_initial_state_matches_reference():
    b, s, h, p, g, n = 2, 48, 4, 16, 2, 16
    pairs = _inputs(2, b, s, h, p, g, n)
    init = np.random.default_rng(3).standard_normal((b, h, p, n)) \
        .astype(np.float32)
    want_y, want_s = ref_ssd(*_j(pairs), chunk=16,
                             initial_state=jnp.asarray(init))
    y, st = ssd_reference(*_t(pairs), chunk=16,
                          initial_state=torch.from_numpy(init))
    _close(y, want_y, F32_TOL)
    _close(st, want_s, F32_TOL)
    # a carried-in state is the state of the prompt before it
    first = _t(_inputs(4, b, 32, h, p, g, n))
    first[2], first[5] = _t(pairs)[2], _t(pairs)[5]     # the same A, D
    whole = [torch.cat([a, c], 1) if a.dim() > 1 else c
             for a, c in zip(first, _t(pairs))]
    _, mid = ssd_reference(*first, chunk=16)
    y2, st2 = ssd_reference(*_t(pairs), chunk=16, initial_state=mid)
    y_all, st_all = ssd_reference(*whole, chunk=16)
    _close(y2, y_all[:, 32:], F32_TOL)
    _close(st2, st_all, F32_TOL)


@pytest.mark.parametrize("g", [1, 2])
def test_decode_step_matches_reference(g):
    rng = np.random.default_rng(5 + g)
    b, h, p, n = 3, 4, 16, 16
    state = rng.standard_normal((b, h, p, n)).astype(np.float32)
    x = rng.standard_normal((b, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    B = rng.standard_normal((b, g, n)).astype(np.float32)
    C = rng.standard_normal((b, g, n)).astype(np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    args = (state, x, dt, A, B, C, D)
    want_s, want_y = ref_decode_step(*map(jnp.asarray, args))
    got_s, got_y = ssd_decode_step(*map(torch.from_numpy, args))
    _close(got_s, want_s, F32_TOL)
    _close(got_y, want_y, F32_TOL)


# ---------------------------------------------------------------------------
# 2. B10's plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", KERNEL_CASES + [(2, 96, 4, 16, 2, 16, 32)],
                         ids=str)
def test_plain_matches_pallas_interpret(case, dtype):
    b, s, h, p, g, n, chunk = case
    pairs = _inputs(6, b, s, h, p, g, n, dtype)
    want_y, want_s = ssd_pallas(*_j(pairs), chunk=chunk, interpret=True)
    y, st = SSD.ssd_fwd(*_t(pairs), chunk=chunk)
    assert y.dtype == DTYPES[dtype][1] and st.dtype == torch.float32
    assert tuple(st.shape) == (b, h, p, n)
    _close(y, want_y, F32_TOL if dtype == "float32" else BF16_TOL)
    _close(st, want_s, F32_TOL)


@pytest.mark.parametrize("decay", ["near_zero", "underflow"])
@pytest.mark.parametrize("case", MORE_CASES, ids=str)
def test_plain_matches_oracle_where_pallas_cannot(case, decay):
    """Ragged tails, s < chunk and 8 groups (the Pallas kernel asserts
    s % chunk == 0), with A near 0 (no decay) and A at -16 with large dt
    (every decay underflows to 0: exp is never taken of a positive
    exponent, so nothing overflows)."""
    b, s, h, p, g, n, chunk = case
    kw = (dict(a_scale=1e-4) if decay == "near_zero"
          else dict(a_scale=16.0, dt_shift=3.0))
    pairs = _inputs(7, b, s, h, p, g, n, **kw)
    want_y, want_s = ssd_reference(*_t(pairs), chunk=chunk)
    y, st = SSD.ssd_plain(*_t(pairs), chunk=chunk)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    _close(y, want_y, F32_TOL)
    _close(st, want_s, F32_TOL)


def test_plain_writes_the_state_into_a_given_tensor():
    pairs = _inputs(8, 2, 50, 4, 16, 2, 16)
    out = torch.full((2, 4, 16, 16), float("nan"))
    y, st = SSD.ssd_fwd(*_t(pairs), chunk=16, out_state=out)
    assert st is out and torch.isfinite(out).all()
    y2, st2 = SSD.ssd_fwd(*_t(pairs), chunk=16)
    assert torch.equal(y, y2) and torch.equal(out, st2)


# ---------------------------------------------------------------------------
# 3. The sequential recurrence
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fn", ["oracle", "plain"])
def test_chunked_form_equals_recurrence(fn):
    b, s, h, p, n = 1, 64, 2, 8, 8
    (_, x), (_, dt), (_, A), (_, B), (_, C), _ = _inputs(9, b, s, h, p, 1, n)
    D = torch.zeros(h)
    scan = ssd_reference if fn == "oracle" else SSD.ssd_plain
    y, st = scan(x, dt, A, B, C, D, chunk=16)
    state = np.zeros((b, h, p, n), np.float32)
    ys = []
    xn, dtn, Bn, Cn, An = (t.numpy() for t in (x, dt, B, C, A))
    for t in range(s):
        decay = np.exp(dtn[:, t] * An[None, :])
        upd = np.einsum("bhp,bn->bhpn", xn[:, t] * dtn[:, t][..., None],
                        Bn[:, t, 0])
        state = state * decay[..., None, None] + upd
        ys.append(np.einsum("bhpn,bn->bhp", state, Cn[:, t, 0]))
    np.testing.assert_allclose(y.numpy(), np.stack(ys, axis=1), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(st.numpy(), state, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# 4. Ops
# ---------------------------------------------------------------------------
def test_ops_dispatch():
    K.reset_launches()
    args = _t(_inputs(10, 2, 40, 4, 16, 1, 16))
    y_k = SOPS.ssd(*args, chunk=16)
    y_p, st_p = SSD.ssd_plain(*args, chunk=16)
    assert torch.equal(y_k, y_p)
    y_ks, st_ks = SOPS.ssd_with_state(*args, chunk=16)
    assert torch.equal(y_ks, y_p) and torch.equal(st_ks, st_p)
    y_r, st_r = ssd_reference(*args, chunk=16)
    assert torch.equal(SOPS.ssd(*args, chunk=16, impl="ref"), y_r)
    out = torch.empty_like(st_r)
    y_rs, st_rs = SOPS.ssd_with_state(*args, chunk=16, impl="ref",
                                      out_state=out)
    assert torch.equal(y_rs, y_r) and st_rs is out and torch.equal(out, st_r)
    assert K.launches["ssd"] == 0
    assert SOPS.ssd_decode_step is ssd_decode_step
    with pytest.raises(ValueError, match="impl"):
        SOPS.ssd(*args, chunk=16, impl="pallas")
    with pytest.raises(ValueError, match="impl"):
        SOPS.ssd_with_state(*args, chunk=16, impl="auto")


def test_devices_the_kernel_cannot_run_on_are_refused():
    args = [t.to("meta") for t in _t(_inputs(11, 1, 16, 2, 16, 1, 16))]
    with pytest.raises(ValueError, match="devices"):
        SSD.ssd_fwd(*args, chunk=16)
    with pytest.raises(ValueError, match="devices"):
        SOPS.ssd(*args, chunk=16)


def test_ssd_function_gradient_matches_jax_vjp():
    """The gradient of B10's op (plain forward here, the oracle's autograd
    backward) against ``jax.vjp`` of the reference oracle — what the
    reference's custom VJP computes."""
    b, s, h, p, g, n, chunk = 2, 40, 4, 16, 2, 16, 16
    pairs = _inputs(12, b, s, h, p, g, n)
    dy = np.random.default_rng(13).standard_normal((b, s, h, p)) \
        .astype(np.float32)
    _, vjp = jax.vjp(lambda *a: ref_ssd(*a, chunk=chunk)[0], *_j(pairs))
    want = vjp(jnp.asarray(dy))
    args = [t.clone().requires_grad_(True) for t in _t(pairs)]
    y = SOPS.ssd(*args, chunk=chunk)
    y.backward(torch.from_numpy(dy))
    for name, a, w in zip("x dt A B C D".split(), args, want):
        assert a.grad is not None, name
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    # only the inputs that want a gradient get one
    x = _t(pairs)[0].clone().requires_grad_(True)
    rest = _t(pairs)[1:]
    SOPS.ssd(x, *rest, chunk=chunk).sum().backward()
    assert x.grad is not None and all(t.grad is None for t in rest)


def test_launcher_checks_arguments():
    """The launcher refuses what the kernel does not take, before
    anything is built (this host has no nvcc)."""
    meta = dict(device="meta")
    x = torch.empty((1, 16, 4, 16), **meta)
    dt = torch.empty((1, 16, 4), **meta)
    A = torch.empty(4, **meta)
    B = torch.empty((1, 16, 2, 16), **meta)
    with pytest.raises(TypeError, match="dtype"):
        K.launch_ssd(x, dt, A, B.half(), B, A, 16)
    with pytest.raises(TypeError, match="dtype"):
        K.launch_ssd(x, dt.double(), A, B, B, A, 16)
    with pytest.raises(ValueError, match="head_dim"):
        x24 = torch.empty((1, 16, 4, 24), **meta)
        K.launch_ssd(x24, dt, A, B, B, A, 16)
    with pytest.raises(ValueError, match="groups"):
        B3 = torch.empty((1, 16, 3, 16), **meta)
        K.launch_ssd(x, dt, A, B3, B3, A, 16)
    with pytest.raises(ValueError, match="contiguous"):
        K.launch_ssd(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A,
                     B, B, A, 16)
    with pytest.raises(ValueError, match="out_state"):
        K.launch_ssd(x, dt, A, B, B, A, 16,
                     out_state=torch.empty((1, 4, 16, 8), **meta))


# ---------------------------------------------------------------------------
# 5. On the card (skips without one)
# ---------------------------------------------------------------------------
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", KERNEL_CASES + MORE_CASES
                         + [(2, 600, 8, 64, 1, 128, 256)], ids=str)
def test_kernel_matches_plain_on_card(case, dtype):
    _need_card()
    b, s, h, p, g, n, chunk = case
    args = [t.cuda() for t in _t(_inputs(14, b, s, h, p, g, n, dtype))]
    before = K.launches["ssd"]
    y, st = SSD.ssd_fwd(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert K.launches["ssd"] == before + 1
    want_y, want_s = SSD.ssd_plain(*args, chunk=chunk)
    torch.testing.assert_close(y.float(), want_y.float(),
                               **(F32_TOL if dtype == "float32"
                                  else BF16_TOL))
    torch.testing.assert_close(st, want_s, **F32_TOL)
