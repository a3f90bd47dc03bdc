"""The port's Mamba-2 (ssm) stack against the reference package, on the CPU.

The reference initialises the weights (``repro.models.model.init_params``)
and :func:`repro_torch.models.convert.from_jax_params` loads the same
weights into the port. Token ids and activations are drawn with numpy
from a seed. Configurations, in float32:

- ``reduced_config(mamba2-2.7b)`` — 4 layers, d_model 64, 8 heads of 16,
  d_state 16, one group, chunk 16;
- a two-group variant of it with chunk 8, so prompts end in ragged
  chunks and heads read their group as ``h // (h // g)``.

1. **Blocks** — ``mamba_block`` (with and without its state) and
   ``mamba_decode`` against the reference's, within 2e-4.
2. **Model** — ``forward`` (both impls), ``prefill`` (cache included)
   and one decode step against the reference's, with the reference on
   its oracle and on its Pallas kernel in interpret mode, within 2e-4;
   three greedy steps within 3e-4 of the reference's decode and of its
   full forward (``tests/test_models.py:83,109``); the cache layout of
   ``init_cache``; the loss gradients against ``jax.value_and_grad``
   (within 1e-4 of each leaf's largest entry).
3. **The port's own consistency** — prefill ≡ decode ≡ forward, a
   prompt shorter than the conv window, the serve-step builders, the
   cache written in place, the weights' distributions.
4. **``chip_smoke.py``'s ssm serving phase** on a narrow model, on the
   CPU.
5. **On the card** (marked ``cuda``; skips without one) — prefill (B10)
   and decode equal the CPU run within 2e-4.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.models import mamba2 as RMB
from repro.models import model as RM
from repro.train import loop as RLOOP
from repro_torch.accel import kernels as K
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as PMB
from repro_torch.models import model as PM
from repro_torch.models.convert import from_jax_params
from repro_torch.train import loop as PLOOP


def _two_groups(cfg):
    return dataclasses.replace(
        cfg, arch_id="mamba2-2.7b-g2-smoke",
        ssm=dataclasses.replace(cfg.ssm, n_groups=2, chunk_size=8))


CONFIGS = {"mamba2-2.7b": None, "mamba2-2.7b-g2": _two_groups}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    """(reference config, port config, reference params, port params)."""
    variant = CONFIGS[request.param]
    rcfg = ref_reduced_config(ref_get_config("mamba2-2.7b"))
    pcfg = reduced_config(get_config("mamba2-2.7b"))
    if variant is not None:
        rcfg, pcfg = variant(rcfg), variant(pcfg)
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(pcfg)
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(7))
    pparams = from_jax_params(pcfg, jax.tree.map(np.asarray, rparams),
                              device="cpu")
    return rcfg, pcfg, rparams, pparams


def _tokens(seed, cfg, b, s):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _layer(rparams, pparams, i=1):
    return (jax.tree.map(lambda t: t[i], rparams["layers"]["mixer"]),
            pparams["layers"][i]["mixer"])


# ---------------------------------------------------------------------------
# 1. Blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("return_state", [False, True])
def test_mamba_block_matches_reference(model, return_state):
    rcfg, pcfg, rparams, pparams = model
    rp, pp = _layer(rparams, pparams)
    h = np.random.default_rng(1).standard_normal((2, 21, pcfg.d_model)) \
        .astype(np.float32)
    want, rcache = RMB.mamba_block(rcfg, rp, jnp.asarray(h),
                                   return_state=return_state)
    got, pcache = PMB.mamba_block(pcfg, pp, torch.from_numpy(h),
                                  return_state=return_state)
    _close(got, want, 2e-4)
    if not return_state:
        assert pcache is None
        return
    for name in ("conv", "state"):
        assert tuple(pcache[name].shape) == rcache[name].shape
        _close(pcache[name], rcache[name], 2e-4)
    # written into a given cache slice: the same values
    out = PMB.init_mamba_cache(pcfg, 2, torch.float32, device="cpu")
    got2, cache2 = PMB.mamba_block(pcfg, pp, torch.from_numpy(h),
                                   return_state=True, out=out)
    assert cache2 is out and torch.equal(got2, got)
    for name in ("conv", "state"):
        assert torch.equal(out[name], pcache[name])


def test_mamba_decode_matches_reference(model):
    rcfg, pcfg, rparams, pparams = model
    rp, pp = _layer(rparams, pparams, 2)
    rng = np.random.default_rng(2)
    h = rng.standard_normal((3, 1, pcfg.d_model)).astype(np.float32)
    shapes = {k: tuple(v.shape) for k, v in
              PMB.init_mamba_cache(pcfg, 3, torch.float32,
                                   device="cpu").items()}
    cache = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
    want, rnew = RMB.mamba_decode(rcfg, rp, jnp.asarray(h),
                                  {k: jnp.asarray(v) for k, v in
                                   cache.items()})
    pc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got, pnew = PMB.mamba_decode(pcfg, pp, torch.from_numpy(h), pc)
    assert pnew is pc
    _close(got, want, 2e-4)
    for name in ("conv", "state"):
        _close(pnew[name], rnew[name], 2e-4)


# ---------------------------------------------------------------------------
# 2. The model against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_forward_matches_reference(model, impl):
    rcfg, pcfg, rparams, pparams = model
    toks = _tokens(0, pcfg, 2, 37)
    want, _, _ = RM.forward(rcfg, rparams, {"tokens": jnp.asarray(toks)})
    got, aux, caches = PM.forward(pcfg, pparams,
                                  {"tokens": torch.from_numpy(toks)},
                                  impl=impl)
    assert got.shape == (2, 37, pcfg.vocab_size) and float(aux) == 0.0
    assert caches is None
    _close(got, want, 2e-4)


@pytest.mark.parametrize("ref_impl", ["ref", "pallas"])
def test_prefill_and_decode_match_reference(model, ref_impl):
    """The Pallas kernel asserts s % chunk == 0: a 32-token prompt."""
    rcfg, pcfg, rparams, pparams = model
    s = 32
    toks = _tokens(2, pcfg, 2, s + 1)
    rlog, rcache = RM.prefill(rcfg, rparams,
                              {"tokens": jnp.asarray(toks[:, :s])},
                              max_len=s + 4, impl=ref_impl)
    plog, pcache = PM.prefill(pcfg, pparams,
                              {"tokens": torch.from_numpy(toks[:, :s])},
                              max_len=s + 4)
    _close(plog, rlog, 2e-4)
    for name in ("conv", "state"):
        assert tuple(pcache["mamba"][name].shape) == \
            rcache["mamba"][name].shape
        _close(pcache["mamba"][name], rcache["mamba"][name], 2e-4)
    rgot, _ = RM.decode_step(rcfg, rparams, rcache, jnp.asarray(toks[:, s]),
                             jnp.full((2,), s, jnp.int32), impl=ref_impl)
    pgot, _ = PM.decode_step(pcfg, pparams, pcache,
                             torch.from_numpy(toks[:, s]),
                             torch.full((2,), s, dtype=torch.int32))
    _close(pgot, rgot, 2e-4)


def test_greedy_decode_matches_reference(model):
    """Three greedy steps (tokens chosen by the reference) after a ragged
    prompt, each against the reference's decode and its full forward."""
    rcfg, pcfg, rparams, pparams = model
    s0, extra = 11, 3
    toks = _tokens(3, pcfg, 1, s0)
    rlog, rcache = RM.prefill(rcfg, rparams, {"tokens": jnp.asarray(toks)})
    plog, pcache = PM.prefill(pcfg, pparams,
                              {"tokens": torch.from_numpy(toks)})
    _close(plog, rlog, 2e-4)
    seq = [int(t) for t in toks[0]]
    nxt = int(jnp.argmax(rlog[0]))
    for i in range(extra):
        seq.append(nxt)
        tok = np.array([nxt], np.int32)
        pos = np.array([s0 + i], np.int32)
        rgot, rcache = RM.decode_step(rcfg, rparams, rcache,
                                      jnp.asarray(tok), jnp.asarray(pos))
        pgot, pcache = PM.decode_step(pcfg, pparams, pcache,
                                      torch.from_numpy(tok),
                                      torch.from_numpy(pos))
        full, _, _ = RM.forward(rcfg, rparams,
                                {"tokens": jnp.asarray([seq], jnp.int32)})
        _close(pgot, rgot, 3e-4)
        _close(pgot, full[:, -1], 3e-4)
        nxt = int(jnp.argmax(rgot[0]))


def test_cache_layout_matches_reference(model):
    rcfg, pcfg, _rparams, _pparams = model
    want = RM.init_cache(rcfg, 3, 10)
    got = PM.init_cache(pcfg, 3, 10, device="cpu")
    assert set(got) == set(want) == {"mamba"}
    for name in ("conv", "state"):
        w, g = want["mamba"][name], got["mamba"][name]
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == w.dtype.name
        assert not g.any()
    s = pcfg.ssm
    nh = s.n_heads(pcfg.d_model)
    assert tuple(got["mamba"]["state"].shape) == (
        pcfg.n_layers, 3, nh, s.head_dim, s.d_state)


def test_loss_gradients_match_reference(model):
    """The ssm stack is differentiable: ``SSDFunction`` (the plain
    forward here, the oracle's autograd backward) through every layer."""
    rcfg, pcfg, rparams, pparams = model
    rng = np.random.default_rng(4)
    toks = rng.integers(0, pcfg.vocab_size, (2, 25)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss_fn = RLOOP.make_loss_fn(rcfg, RLOOP.TrainConfig())
    (_, rmetrics), rgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        rparams, {k: jnp.asarray(v) for k, v in batch.items()})
    want = L.tree_leaves(from_jax_params(
        pcfg, jax.tree.map(np.asarray, rgrads), device="cpu"))
    params = L.tree_from_leaves(pparams, L.tree_leaves(pparams),
                                trainable=True)
    grads, metrics = PLOOP.make_grad_fn(pcfg, PLOOP.TrainConfig())(
        params, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(rmetrics["loss"]), rtol=2e-4)
    assert list(grads) == list(want)
    for k in want:
        w = want[k].numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(_np(grads[k]), w, rtol=0,
                                   atol=1e-4 * scale, err_msg=k)


# ---------------------------------------------------------------------------
# 3. The port's own consistency
# ---------------------------------------------------------------------------
def test_prefill_decode_consistency(model):
    """Decoding token s+1 with a prefilled cache gives the logits of a
    full forward over the s+1 tokens (tests/test_models.py's property)."""
    _rcfg, pcfg, _rparams, pparams = model
    s = 19
    toks = torch.from_numpy(_tokens(5, pcfg, 2, s + 1))
    full, _, _ = PM.forward(pcfg, pparams, {"tokens": toks})
    plog, cache = PM.prefill(pcfg, pparams, {"tokens": toks[:, :s]})
    torch.testing.assert_close(plog, full[:, s - 1], rtol=2e-4, atol=2e-4)
    got, _ = PM.decode_step(pcfg, pparams, cache, toks[:, s],
                            torch.full((2,), s, dtype=torch.int32))
    torch.testing.assert_close(got, full[:, -1], rtol=2e-4, atol=2e-4)


def test_prompt_shorter_than_the_conv_window(model):
    """A 2-token prompt under a 4-tap conv: the cache's tail holds a zero
    row in front (the conv's causal padding), so decode continues the
    full forward."""
    _rcfg, pcfg, _rparams, pparams = model
    toks = torch.from_numpy(_tokens(6, pcfg, 2, 4))
    full, _, _ = PM.forward(pcfg, pparams, {"tokens": toks})
    plog, cache = PM.prefill(pcfg, pparams, {"tokens": toks[:, :2]})
    assert not cache["mamba"]["conv"][:, :, 0].any()
    torch.testing.assert_close(plog, full[:, 1], rtol=2e-4, atol=2e-4)
    for s in (2, 3):
        got, cache = PM.decode_step(pcfg, pparams, cache, toks[:, s],
                                    torch.full((2,), s, dtype=torch.int32))
        torch.testing.assert_close(got, full[:, s], rtol=2e-4, atol=2e-4)


def test_serve_steps_write_the_cache_in_place(model):
    _rcfg, pcfg, _rparams, pparams = model
    tc = PLOOP.TrainConfig()
    s = 13
    toks = torch.from_numpy(_tokens(7, pcfg, 2, s + 1))
    _, cache = PLOOP.make_prefill_step(pcfg, tc, max_len=s + 5)(
        pparams, {"tokens": toks[:, :s]})
    state, conv = cache["mamba"]["state"], cache["mamba"]["conv"]
    _, _, collected = PM.forward(pcfg, pparams, {"tokens": toks[:, :s]},
                                 collect_cache=True)
    assert torch.equal(state, collected["state"])
    assert torch.equal(conv, collected["conv"])
    before = state.clone()
    step = PLOOP.make_serve_step(pcfg, tc)
    out, cache2 = step(pparams, cache, toks[:, s],
                       torch.full((2,), s, dtype=torch.int32))
    assert cache2 is cache and cache2["mamba"]["state"] is state
    assert not torch.equal(state, before)
    assert out.shape == (2, pcfg.vocab_size) and torch.isfinite(out).all()


def test_init_params_distributions():
    """The reference's distributions: A_log = log(linspace(1, 16, heads))
    in the parameter type, D ones, dt_bias zeros, normal weights scaled
    by fan-in (the conv by taps^-½); the reference's tree size."""
    rcfg = ref_reduced_config(ref_get_config("mamba2-2.7b"))
    pcfg = reduced_config(get_config("mamba2-2.7b"))
    ref = RM.init_params(rcfg, jax.random.PRNGKey(0))
    p = PM.init_params(pcfg, 0, device="cpu")
    n = sum(t.numel() for t in p.parameters())
    rflat = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert n == sum(int(np.prod(leaf.shape)) for _path, leaf in rflat)
    assert n == pcfg.param_counts()[0]
    for i, layer in enumerate(p["layers"]):
        mixer = layer["mixer"]
        rmixer = jax.tree.map(lambda t: t[i], ref["layers"]["mixer"])
        for name in ("A_log", "D", "dt_bias", "conv_b", "gate_norm"):
            np.testing.assert_allclose(mixer[name].numpy(),
                                       np.asarray(rmixer[name]), rtol=1e-6,
                                       atol=0, err_msg=name)
    m = p["layers"][0]["mixer"]
    d, k = pcfg.d_model, pcfg.ssm.conv_kernel
    assert abs(float(m["wx"].std()) - d ** -0.5) < 0.1 * d ** -0.5
    assert abs(float(m["conv_w"].std()) - k ** -0.5) < 0.1 * k ** -0.5
    # bf16 weights: A_log rounded to the parameter type, as the reference
    bcfg = dataclasses.replace(pcfg, param_dtype="bfloat16")
    b16 = PM.init_params(bcfg, 0, device="cpu")["layers"][0]["mixer"]
    rb16 = RM.init_params(dataclasses.replace(rcfg, param_dtype="bfloat16"),
                          jax.random.PRNGKey(0))["layers"]["mixer"]["A_log"]
    assert b16["A_log"].dtype == torch.bfloat16
    np.testing.assert_array_equal(b16["A_log"].float().numpy(),
                                  np.asarray(rb16[0], np.float32))
    # the same seed gives the same weights
    again = PM.init_params(pcfg, 0, device="cpu")
    assert torch.equal(again["layers"][3]["mixer"]["wo"],
                       p["layers"][3]["mixer"]["wo"])


def test_full_config_counts_and_cache():
    """Mamba2-2.7B at full width: the parameter count chip_smoke.py
    serves and its decode cache's size, from the config alone."""
    cfg = get_config("mamba2-2.7b")
    total, _ = cfg.param_counts()
    assert 2.6e9 < total < 2.8e9
    s = cfg.ssm
    nh = s.n_heads(cfg.d_model)
    assert (nh, s.head_dim, s.d_state, s.chunk_size) == (80, 64, 128, 256)
    state_bytes = cfg.n_layers * 4 * nh * s.head_dim * s.d_state * 4
    assert state_bytes == 671_088_640


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config(get_config("mamba2-2.7b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PM.init_params(cfg, 0)


# ---------------------------------------------------------------------------
# 4. chip_smoke.py's ssm serving phase, reduced, on the CPU
# ---------------------------------------------------------------------------
def test_chip_smoke_ssm_serve_path_rehearses_on_cpu(monkeypatch, capsys):
    """The card's ssm serving phase end to end on the plain versions: a
    narrow Mamba2 (3 layers, 8 heads of 32, d_state 32, chunk 16) through
    the same prefill, greedy decode, f32 reference comparison of the
    logits and the states, and fp8 probe."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    # a narrow layer's maximum is over fewer entries than at full width:
    # this run prints bf16 at most 0.18 of the RMS, the fp8 probe 0.73,
    # so the limit is 0.4
    for name, value in (("SSM_PROMPT", 40), ("SSM_STEPS", 6),
                        ("SSM_CHECKS", (1, 3, 6)), ("SSM_LAYER_TOL", 0.4)):
        monkeypatch.setattr(chip_smoke, name, value)
    base = get_config("mamba2-2.7b")
    cfg = dataclasses.replace(
        base, n_layers=3, d_model=128, vocab_size=1000,
        ssm=dataclasses.replace(base.ssm, head_dim=32, d_state=32,
                                chunk_size=16))
    counts = chip_smoke.ssm_serve_path(cfg, device="cpu")
    assert counts["ssd"] == 0
    out = capsys.readouterr().out
    assert "decode step 6" in out and "fp8-activation probe" in out
    assert "final states vs the f32 reference" in out


# ---------------------------------------------------------------------------
# 5. On the card (marked cuda; skips without one)
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_ssm_serving_on_card_matches_cpu(model):
    """Prefill through B10 (float32) and a decode step on the card give
    the CPU run's logits and cache within 2e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    _rcfg, pcfg, _rparams, pparams = model
    card = copy.deepcopy(pparams).to("cuda")
    s = 70
    toks = torch.from_numpy(_tokens(8, pcfg, 2, s + 1))
    want_p, want_c = PM.prefill(pcfg, pparams, {"tokens": toks[:, :s]})
    K.reset_launches()
    got_p, cache = PM.prefill(pcfg, card, {"tokens": toks[:, :s].cuda()})
    assert K.launches["ssd"] == pcfg.n_layers
    for name in ("conv", "state"):
        torch.testing.assert_close(cache["mamba"][name].cpu(),
                                   want_c["mamba"][name], rtol=2e-4,
                                   atol=2e-4)
    want_d, _ = PM.decode_step(pcfg, pparams, want_c, toks[:, s],
                               torch.full((2,), s, dtype=torch.int32))
    got_d, _ = PM.decode_step(pcfg, card, cache, toks[:, s].cuda(),
                              torch.full((2,), s, dtype=torch.int32,
                                         device="cuda"))
    assert K.launches["ssd"] == pcfg.n_layers
    torch.testing.assert_close(got_p.cpu(), want_p, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(got_d.cpu(), want_d, rtol=2e-4, atol=2e-4)
