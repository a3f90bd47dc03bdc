"""The port's dense model stack against the reference package, on the CPU.

The reference initialises the weights (``repro.models.model.init_params``)
and :func:`repro_torch.models.convert.from_jax_params` loads the same
weights into the port. Token ids are drawn with numpy from a seed.
Configurations:

- ``reduced_config(qwen3-8b)`` — qk-norm, MQA at that size (4 heads, 1
  KV head);
- a GQA-4 variant of it — 4 layers, d_model 128, 8 query heads over 2 KV
  heads, head_dim 32, qk-norm — the grouping Qwen3-8B has at full width;
- ``reduced_config(qwen1.5-0.5b)`` — QKV bias and tied embeddings.

1. **Forward** — the port's logits (both impls) against the reference's
   ``forward`` (``impl="ref"``), in f32, within 2e-4.
2. **Serving** — the port's ``prefill`` then ``decode_step`` against the
   reference's, with the reference on its oracle (``impl="ref"``) and on
   its Pallas kernels in interpret mode (``impl="pallas"``): the prefill
   logits, the cache, and one decode step within 2e-4; three greedy steps
   within 3e-4 of the reference's decode and of its full forward
   (``tests/test_models.py:58-109``).
3. **The port's own consistency** — prefill ≡ decode ≡ forward, the
   serve-step builders, the cache written in place.
4. **Conversion** — a bfloat16 tree loads bit for bit (``uint16`` views,
   no ``ml_dtypes`` needed); the weights keep the reference's layout.
5. **What waits** — the moe, hybrid, audio and vlm families (the ssm
   family is held in ``tests/test_torch_mamba.py``), the dry-run's
   train-state trees and the ``dist`` decode raise.
6. **``chip_smoke.py``'s serving phase** on a narrow model, on the CPU.
7. **On the card** (marked ``cuda``; skips without one) — prefill and
   decode through B6 and B9 equal the CPU run within 2e-4.
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
from repro.models import model as RM
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.models import model as PM
from repro_torch.models.convert import from_jax_params
from repro_torch.train.loop import (
    TrainConfig, make_prefill_step, make_serve_step, make_train_step,
    train_state_init, train_state_shapes)


def _gqa4(cfg):
    return dataclasses.replace(cfg, arch_id="qwen3-8b-gqa4-smoke",
                               n_layers=4, d_model=128, n_heads=8,
                               n_kv_heads=2, head_dim=32, qk_norm=True)


CONFIGS = {
    "qwen3-8b-mqa": ("qwen3-8b", None),
    "qwen3-8b-gqa4": ("qwen3-8b", _gqa4),
    "qwen1.5-0.5b": ("qwen1.5-0.5b", None),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    """(reference config, port config, reference params, port params)."""
    arch, variant = CONFIGS[request.param]
    rcfg = ref_reduced_config(ref_get_config(arch))
    pcfg = reduced_config(get_config(arch))
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


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# 1. Forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_forward_matches_reference(model, impl):
    rcfg, pcfg, rparams, pparams = model
    toks = _tokens(0, pcfg, 2, 24)
    want, _, _ = RM.forward(rcfg, rparams, {"tokens": jnp.asarray(toks)})
    got, aux, kv = PM.forward(pcfg, pparams,
                              {"tokens": torch.from_numpy(toks)}, impl=impl)
    assert got.shape == (2, 24, pcfg.vocab_size) and float(aux) == 0.0
    assert kv is None
    _close(got, want, 2e-4)


def test_forward_options_for_a_reference_run(model):
    """``last_only`` keeps the last position's logits; ``compute_dtype``
    casts the weights per layer (here to float64, for the check)."""
    _rcfg, pcfg, _rparams, pparams = model
    toks = torch.from_numpy(_tokens(1, pcfg, 2, 12))
    full, _, _ = PM.forward(pcfg, pparams, {"tokens": toks})
    last, _, _ = PM.forward(pcfg, pparams, {"tokens": toks}, impl="ref",
                            last_only=True)
    assert last.shape == (2, 1, pcfg.vocab_size)
    torch.testing.assert_close(last[:, 0], full[:, -1], rtol=2e-4,
                               atol=2e-4)
    wide, _, _ = PM.forward(pcfg, pparams, {"tokens": toks}, impl="ref",
                            compute_dtype=torch.float64, last_only=True)
    assert wide.dtype == torch.float64
    assert next(pparams.parameters()).dtype == torch.float32
    torch.testing.assert_close(wide[:, 0].float(), full[:, -1], rtol=2e-4,
                               atol=2e-4)


# ---------------------------------------------------------------------------
# 2. Serving against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ref_impl", ["ref", "pallas"])
def test_prefill_and_decode_match_reference(model, ref_impl):
    rcfg, pcfg, rparams, pparams = model
    s, max_len = 16, 20
    toks = _tokens(2, pcfg, 2, s + 1)
    rlog, rcache = RM.prefill(rcfg, rparams,
                              {"tokens": jnp.asarray(toks[:, :s])},
                              max_len=max_len, impl=ref_impl)
    plog, pcache = PM.prefill(pcfg, pparams,
                              {"tokens": torch.from_numpy(toks[:, :s])},
                              max_len=max_len)
    _close(plog, rlog, 2e-4)
    for name in ("k", "v"):
        assert tuple(pcache["attn"][name].shape) == \
            rcache["attn"][name].shape
        _close(pcache["attn"][name], rcache["attn"][name], 2e-4)
    rgot, _ = RM.decode_step(rcfg, rparams, rcache,
                             jnp.asarray(toks[:, s]),
                             jnp.full((2,), s, jnp.int32), impl=ref_impl)
    pgot, _ = PM.decode_step(pcfg, pparams, pcache,
                             torch.from_numpy(toks[:, s]),
                             torch.full((2,), s, dtype=torch.int32))
    _close(pgot, rgot, 2e-4)


def test_greedy_decode_matches_reference(model):
    """Three greedy steps (tokens chosen by the reference) on both
    stacks, each against the reference's decode and its full forward."""
    rcfg, pcfg, rparams, pparams = model
    s0, extra = 8, 3
    toks = _tokens(3, pcfg, 1, s0)
    rlog, rcache = RM.prefill(rcfg, rparams, {"tokens": jnp.asarray(toks)},
                              max_len=s0 + extra + 1)
    plog, pcache = PM.prefill(pcfg, pparams,
                              {"tokens": torch.from_numpy(toks)},
                              max_len=s0 + extra + 1)
    seq = [int(t) for t in toks[0]]
    nxt = int(jnp.argmax(rlog[0]))
    for i in range(extra):
        seq.append(nxt)
        tok = np.array([nxt], np.int32)
        rgot, rcache = RM.decode_step(rcfg, rparams, rcache,
                                      jnp.asarray(tok),
                                      jnp.array([s0 + i], jnp.int32))
        pgot, pcache = PM.decode_step(pcfg, pparams, pcache,
                                      torch.from_numpy(tok),
                                      torch.tensor([s0 + i],
                                                   dtype=torch.int32))
        full, _, _ = RM.forward(rcfg, rparams,
                                {"tokens": jnp.asarray([seq], jnp.int32)})
        _close(pgot, rgot, 3e-4)
        _close(pgot, full[:, -1], 3e-4)
        nxt = int(jnp.argmax(rgot[0]))


# ---------------------------------------------------------------------------
# 3. The port's own consistency
# ---------------------------------------------------------------------------
def test_prefill_decode_consistency(model):
    """Decoding token s+1 with a prefilled cache gives the logits of a
    full forward over the s+1 tokens (tests/test_models.py's property)."""
    _rcfg, pcfg, _rparams, pparams = model
    s = 16
    toks = torch.from_numpy(_tokens(4, pcfg, 2, s + 1))
    full, _, _ = PM.forward(pcfg, pparams, {"tokens": toks})
    plog, cache = PM.prefill(pcfg, pparams, {"tokens": toks[:, :s]},
                             max_len=s + 4)
    torch.testing.assert_close(plog, full[:, s - 1], rtol=2e-4, atol=2e-4)
    got, _ = PM.decode_step(pcfg, pparams, cache, toks[:, s],
                            torch.full((2,), s, dtype=torch.int32))
    torch.testing.assert_close(got, full[:, -1], rtol=2e-4, atol=2e-4)


def test_serve_steps_write_the_cache_in_place(model):
    _rcfg, pcfg, _rparams, pparams = model
    tc = TrainConfig()
    assert tc.impl == "kernel"
    s = 6
    toks = torch.from_numpy(_tokens(5, pcfg, 2, s + 1))
    logits, cache = make_prefill_step(pcfg, tc, max_len=s + 2)(
        pparams, {"tokens": toks[:, :s]})
    k = cache["attn"]["k"]
    assert k.shape == (pcfg.n_layers, 2, s + 2, pcfg.n_kv_heads,
                       pcfg.resolved_head_dim())
    assert not k[:, :, s:].any()
    _, collected = PM.forward(pcfg, pparams, {"tokens": toks[:, :s]},
                              collect_cache=True)[1:]
    torch.testing.assert_close(k[:, :, :s], collected["k"])
    step = make_serve_step(pcfg, tc)
    out, cache2 = step(pparams, cache, toks[:, s],
                       torch.full((2,), s, dtype=torch.int32))
    assert cache2 is cache and cache2["attn"]["k"] is k
    assert k[:, :, s].any() and not k[:, :, s + 1:].any()
    assert out.shape == (2, pcfg.vocab_size) and torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# 4. Conversion
# ---------------------------------------------------------------------------
def test_from_jax_params_bf16_bit_equal():
    rcfg = dataclasses.replace(ref_reduced_config(ref_get_config("qwen3-8b")),
                               param_dtype="bfloat16",
                               activation_dtype="bfloat16")
    pcfg = dataclasses.replace(reduced_config(get_config("qwen3-8b")),
                               param_dtype="bfloat16",
                               activation_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, RM.init_params(rcfg, jax.random.PRNGKey(1)))
    assert tree["embed"].dtype.name == "bfloat16"
    port = from_jax_params(pcfg, tree, device="cpu")
    assert port["embed"].dtype == torch.bfloat16
    assert np.array_equal(port["embed"].view(torch.int16).numpy(),
                          tree["embed"].view(np.int16))
    wq = tree["layers"]["mixer"]["wq"]
    assert wq.shape[0] == pcfg.n_layers
    for i, layer in enumerate(port["layers"]):
        assert tuple(layer["mixer"]["wq"].shape) == wq.shape[1:]
        assert np.array_equal(layer["mixer"]["wq"].view(torch.int16).numpy(),
                              wq[i].view(np.int16))
    assert all(not p.requires_grad for p in port.parameters())


def test_init_params_layout_and_scales():
    cfg = _gqa4(reduced_config(get_config("qwen3-8b")))
    p = PM.init_params(cfg, 0, device="cpu")
    ref = RM.init_params(_gqa4(ref_reduced_config(ref_get_config("qwen3-8b"))),
                         jax.random.PRNGKey(0))
    rflat = jax.tree_util.tree_flatten_with_path(ref)[0]
    n = sum(t.numel() for t in p.parameters())
    assert n == sum(int(np.prod(leaf.shape)) for _path, leaf in rflat)
    assert n == cfg.param_counts()[0]
    wq = p["layers"][0]["mixer"]["wq"]
    assert tuple(wq.shape) == (128, 8, 32)
    assert abs(float(wq.std()) - 128 ** -0.5) < 0.1 * 128 ** -0.5
    wo = p["layers"][0]["mixer"]["wo"]
    assert abs(float(wo.std()) - 256 ** -0.5) < 0.1 * 256 ** -0.5
    # the same seed gives the same weights
    again = PM.init_params(cfg, 0, device="cpu")
    assert torch.equal(again["embed"], p["embed"])


# ---------------------------------------------------------------------------
# 5. What waits for later slices
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if get_config(a).family
                                  not in ("dense", "ssm")])
def test_non_dense_families_raise(arch):
    cfg = reduced_config(get_config(arch))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PM.init_params(cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PM.init_cache(cfg, 1, 8, device="cpu")


def test_training_and_dist_decode_raise(model):
    """Training is ported (``tests/test_torch_training.py``); what waits
    raises: the dry-run's train-state trees and the ``dist`` decode."""
    _rcfg, pcfg, _rparams, pparams = model
    assert callable(make_train_step(pcfg, TrainConfig()))
    state = train_state_init(pcfg, 0, TrainConfig(), device="cpu")
    assert int(state["step"]) == 0
    with pytest.raises(NotImplementedError, match="dry-run"):
        train_state_shapes(pcfg, TrainConfig())
    _, cache = PM.prefill(pcfg, pparams,
                          {"tokens": torch.zeros((1, 4), dtype=torch.int32)},
                          max_len=6)
    with pytest.raises(NotImplementedError, match="dist"):
        PM.decode_step(pcfg, pparams, cache,
                       torch.zeros(1, dtype=torch.int32),
                       torch.tensor([4], dtype=torch.int32), impl="dist")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config(get_config("qwen3-8b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PM.init_params(cfg, 0)


# ---------------------------------------------------------------------------
# 6. chip_smoke.py's serving phase, reduced, on the CPU
# ---------------------------------------------------------------------------
def test_chip_smoke_serve_path_rehearses_on_cpu(monkeypatch, capsys):
    """The card's serving phase end to end on the plain versions: a
    narrow Qwen3-8B (3 layers, GQA-4) through the same prefill, greedy
    decode, f32 reference comparison and fp8 probe."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    # 3 layers compound less rounding than 36: bf16 about 0.03 of the
    # logits' RMS here, the fp8 probe about 0.19, so the limit is 0.1
    for name, value in (("SERVE_PROMPT", 24), ("SERVE_MAX_LEN", 40),
                        ("SERVE_STEPS", 6), ("SERVE_CHECKS", (1, 3, 6)),
                        ("SERVE_TOL", 0.1)):
        monkeypatch.setattr(chip_smoke, name, value)
    cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=3,
                              d_model=256, n_heads=8, n_kv_heads=2,
                              head_dim=32, d_ff=512, vocab_size=1000)
    counts = chip_smoke.serve_path(cfg, device="cpu")
    assert counts["flash_fwd"] == 0 and counts["decode"] == 0
    out = capsys.readouterr().out
    assert "decode step 6" in out and "fp8-activation probe" in out


# ---------------------------------------------------------------------------
# 7. On the card (marked cuda; skips without one)
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_serving_on_card_matches_cpu(model):
    """The GQA and MQA stacks on the card (B6 and B9 in float32) give the
    CPU run's logits (the plain versions) within 2e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    from repro_torch.accel import kernels as K
    _rcfg, pcfg, _rparams, pparams = model
    card = copy.deepcopy(pparams).to("cuda")
    s = 70
    toks = torch.from_numpy(_tokens(6, pcfg, 2, s + 1))
    want_p, want_c = PM.prefill(pcfg, pparams, {"tokens": toks[:, :s]},
                                max_len=s + 2)
    want_d, _ = PM.decode_step(pcfg, pparams, want_c, toks[:, s],
                               torch.full((2,), s, dtype=torch.int32))
    K.reset_launches()
    got_p, cache = PM.prefill(pcfg, card, {"tokens": toks[:, :s].cuda()},
                              max_len=s + 2)
    got_d, _ = PM.decode_step(pcfg, card, cache, toks[:, s].cuda(),
                              torch.full((2,), s, dtype=torch.int32,
                                         device="cuda"))
    assert K.launches["flash_fwd"] == pcfg.n_layers
    assert K.launches["decode"] == pcfg.n_layers
    torch.testing.assert_close(got_p.cpu(), want_p, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(got_d.cpu(), want_d, rtol=2e-4, atol=2e-4)
