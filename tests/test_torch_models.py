"""The port's model stacks against the reference package, on the CPU.

The reference initialises the weights (``repro.models.model.init_params``)
and :func:`repro_torch.models.convert.from_jax_params` loads the same
weights into the port. Token ids and frame or patch features are drawn
with numpy from a seed. Configurations, each at ``reduced_config``:

- ``qwen3-8b`` — qk-norm, MQA at that size (4 heads, 1 KV head);
- a GQA-4 variant of it — 4 layers, d_model 128, 8 query heads over 2 KV
  heads, head_dim 32, qk-norm — the grouping Qwen3-8B has at full width;
- ``qwen1.5-0.5b`` — QKV bias and tied embeddings;
- ``codeqwen1.5-7b`` (MHA, QKV bias) and ``granite-20b`` (MQA,
  layernorm, gelu MLP) — the other dense architectures;
- ``phi3.5-moe`` and ``moonshot`` — every FFN slot a top-2 MoE of 8
  experts (swiglu);
- ``jamba`` — two hybrid blocks of 4 layers (attention at index 2, three
  Mamba-2 layers, MoE at 1 and 3, dense MLPs at 0 and 2);
- ``hubert`` — the audio frontend (frame features projected), layernorm,
  gelu, non-causal attention, encoder-only;
- ``internvl2`` — the VLM frontend (4 projected patches ahead of the
  text).

1. **Forward** — the port's logits (both impls) and MoE aux loss against
   the reference's ``forward`` (``impl="ref"``), in f32, within 2e-4.
2. **Serving** — the port's ``prefill`` then ``decode_step`` against the
   reference's, with the reference on its oracle (``impl="ref"``) and on
   its Pallas kernels in interpret mode (``impl="pallas"``): the prefill
   logits, the cache, and one decode step within 2e-4; three greedy steps
   within 3e-4 of the reference's decode and of its full forward
   (``tests/test_models.py:58-109``). Encoder-only hubert has no decode
   step: its cache and decode raise, as the reference lists no decode
   shape for it.
3. **The port's own consistency** — prefill ≡ decode ≡ forward, the
   serve-step builders, the cache written in place.
4. **Conversion** — a bfloat16 tree loads bit for bit (``uint16`` views,
   no ``ml_dtypes`` needed), every leaf of every family; the weights keep
   the reference's layout.
5. **MoE gradients** — the loss's gradients of the moe and hybrid
   configurations against the reference's ``jax.grad`` within 1e-4.
6. **What waits** — the ``"dots"`` remat policies, the dry-run's
   train-state and parameter trees, ``input_axes`` and the ``dist``
   decode raise.
7. **``chip_smoke.py``'s serving phases** on narrow models, on the CPU.
8. **On the card** (marked ``cuda``; skips without one) — prefill and
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
from repro.train import loop as RLOOP
from repro_torch.configs import TRAIN_4K, get_config, reduced_config
from repro_torch.models import layers as L
from repro_torch.models import model as PM
from repro_torch.models.convert import from_jax_params
from repro_torch.models.inputs import input_axes
from repro_torch.train import loop as PLOOP
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
    "codeqwen1.5": ("codeqwen1.5-7b", None),
    "granite": ("granite-20b", None),
    "phi3.5-moe": ("phi3.5-moe-42b-a6.6b", None),
    "moonshot": ("moonshot-v1-16b-a3b", None),
    "jamba": ("jamba-1.5-large-398b", None),
    "hubert": ("hubert-xlarge", None),
    "internvl2": ("internvl2-2b", None),
}
MOE_CONFIGS = ("phi3.5-moe", "moonshot", "jamba")


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


def _batch(seed, cfg, b, s):
    """A numpy batch of ``s`` positions for ``cfg``'s family: token ids;
    for audio ``s`` frame features; for vlm ``n_prefix`` patch features
    ahead of ``s - n_prefix`` token ids."""
    rng = np.random.default_rng(seed)
    if cfg.frontend is None:
        return {"tokens": rng.integers(0, cfg.vocab_size, (b, s))
                .astype(np.int32)}
    n_p = s if cfg.family == "audio" else cfg.frontend.n_prefix
    out = {"feats": rng.standard_normal((b, n_p, cfg.frontend.feature_dim))
           .astype(np.float32)}
    if cfg.family == "vlm":
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s - n_p)
                                     ).astype(np.int32)
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _cut(batch, n):
    """The batch with its token ids cut to ``[:n]`` (features kept
    whole)."""
    return {k: (v[:, :n] if k == "tokens" else v) for k, v in batch.items()}


def _cache_leaves(cache, prefix=""):
    """The leaves of a (reference or port) cache by path."""
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out.update(_cache_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


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
    batch = _batch(0, pcfg, 2, 24)
    want, want_aux, _ = RM.forward(rcfg, rparams, _jax(batch))
    got, aux, kv = PM.forward(pcfg, pparams, _torch(batch), impl=impl)
    assert got.shape == (2, 24, pcfg.vocab_size) and kv is None
    assert aux.dtype == torch.float32 and aux.shape == ()
    _close(got, want, 2e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=2e-4,
                               atol=1e-7)
    assert (float(aux) > 0) == (pcfg.moe is not None)


def test_forward_options_for_a_reference_run(model):
    """``last_only`` keeps the last position's logits; ``compute_dtype``
    casts the weights per layer (here to float64, for the check)."""
    _rcfg, pcfg, _rparams, pparams = model
    batch = _torch(_batch(1, pcfg, 2, 12))
    full, _, _ = PM.forward(pcfg, pparams, batch)
    last, _, _ = PM.forward(pcfg, pparams, batch, impl="ref",
                            last_only=True)
    assert last.shape == (2, 1, pcfg.vocab_size)
    torch.testing.assert_close(last[:, 0], full[:, -1], rtol=2e-4,
                               atol=2e-4)
    wide, _, _ = PM.forward(pcfg, pparams, batch, impl="ref",
                            compute_dtype=torch.float64, last_only=True)
    assert wide.dtype == torch.float64
    assert next(pparams.parameters()).dtype == torch.float32
    torch.testing.assert_close(wide[:, 0].float(), full[:, -1], rtol=2e-4,
                               atol=2e-4)


# ---------------------------------------------------------------------------
# 2. Serving against the reference
# ---------------------------------------------------------------------------
def _no_decode(pcfg, pparams, cache):
    """Encoder-only: no cache to decode from, no decode step."""
    assert pcfg.is_encoder_only()
    with pytest.raises(ValueError, match="encoder-only"):
        PM.init_cache(pcfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        PM.decode_step(pcfg, pparams, cache, torch.zeros(1, dtype=torch.int32),
                       torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("ref_impl", ["ref", "pallas"])
def test_prefill_and_decode_match_reference(model, ref_impl):
    rcfg, pcfg, rparams, pparams = model
    s, max_len = 16, 20
    batch = _batch(2, pcfg, 2, s + 1)
    prompt = _cut(batch, -1) if pcfg.family != "audio" else \
        {"feats": batch["feats"][:, :s]}
    rlog, rcache = RM.prefill(rcfg, rparams, _jax(prompt), max_len=max_len,
                              impl=ref_impl)
    plog, pcache = PM.prefill(pcfg, pparams, _torch(prompt),
                              max_len=max_len)
    _close(plog, rlog, 2e-4)
    want, got = _cache_leaves(rcache), _cache_leaves(pcache)
    assert sorted(got) == sorted(want)
    for name in want:
        assert tuple(got[name].shape) == want[name].shape, name
        _close(got[name], want[name], 2e-4)
    if pcfg.is_encoder_only():
        _no_decode(pcfg, pparams, pcache)
        return
    tok = batch["tokens"][:, -1]
    rgot, _ = RM.decode_step(rcfg, rparams, rcache, jnp.asarray(tok),
                             jnp.full((2,), s, jnp.int32), impl=ref_impl)
    pgot, _ = PM.decode_step(pcfg, pparams, pcache, torch.from_numpy(tok),
                             torch.full((2,), s, dtype=torch.int32))
    _close(pgot, rgot, 2e-4)


def test_greedy_decode_matches_reference(model):
    """Three greedy steps (tokens chosen by the reference) on both
    stacks, each against the reference's decode and its full forward
    (at this size no MoE call drops a token: 8 tokens of 2 slots against
    128 places an expert)."""
    rcfg, pcfg, rparams, pparams = model
    s0, extra = 8, 3
    prompt = _batch(3, pcfg, 1, s0)
    rlog, rcache = RM.prefill(rcfg, rparams, _jax(prompt),
                              max_len=s0 + extra + 1)
    plog, pcache = PM.prefill(pcfg, pparams, _torch(prompt),
                              max_len=s0 + extra + 1)
    _close(plog, rlog, 2e-4)
    if pcfg.is_encoder_only():
        _no_decode(pcfg, pparams, pcache)
        return
    seq = dict(prompt)
    nxt = int(jnp.argmax(rlog[0]))
    for i in range(extra):
        tok = np.array([nxt], np.int32)
        seq["tokens"] = np.concatenate([seq["tokens"], tok[None]], axis=1)
        rgot, rcache = RM.decode_step(rcfg, rparams, rcache,
                                      jnp.asarray(tok),
                                      jnp.array([s0 + i], jnp.int32))
        pgot, pcache = PM.decode_step(pcfg, pparams, pcache,
                                      torch.from_numpy(tok),
                                      torch.tensor([s0 + i],
                                                   dtype=torch.int32))
        full, _, _ = RM.forward(rcfg, rparams, _jax(seq))
        _close(pgot, rgot, 3e-4)
        _close(pgot, full[:, -1], 3e-4)
        nxt = int(jnp.argmax(rgot[0]))


# ---------------------------------------------------------------------------
# 3. The port's own consistency
# ---------------------------------------------------------------------------
def test_prefill_decode_consistency(model):
    """Decoding position s+1 with a prefilled cache gives the logits of a
    full forward over the s+1 positions (tests/test_models.py's
    property); the prefill's logits are the forward's at position s."""
    _rcfg, pcfg, _rparams, pparams = model
    s = 16
    batch = _torch(_batch(4, pcfg, 2, s + 1))
    full, _, _ = PM.forward(pcfg, pparams, batch)
    if pcfg.is_encoder_only():
        plog, cache = PM.prefill(pcfg, pparams, batch, max_len=s + 4)
        torch.testing.assert_close(plog, full[:, -1], rtol=2e-4, atol=2e-4)
        _no_decode(pcfg, pparams, cache)
        return
    plog, cache = PM.prefill(pcfg, pparams, _cut(batch, -1), max_len=s + 4)
    torch.testing.assert_close(plog, full[:, s - 1], rtol=2e-4, atol=2e-4)
    got, _ = PM.decode_step(pcfg, pparams, cache, batch["tokens"][:, -1],
                            torch.full((2,), s, dtype=torch.int32))
    torch.testing.assert_close(got, full[:, -1], rtol=2e-4, atol=2e-4)


def test_serve_steps_write_the_cache_in_place(model):
    _rcfg, pcfg, _rparams, pparams = model
    tc = TrainConfig()
    assert tc.impl == "kernel"
    s = 6
    batch = _torch(_batch(5, pcfg, 2, s + 1))
    prompt = _cut(batch, -1) if pcfg.family != "audio" else \
        {"feats": batch["feats"][:, :s]}
    logits, cache = make_prefill_step(pcfg, tc, max_len=s + 2)(pparams,
                                                               prompt)
    k = cache["attn"]["k"]
    units = pcfg.n_layers if pcfg.hybrid is None else PM.n_blocks(pcfg)
    assert k.shape == (units, 2, s + 2, pcfg.n_kv_heads,
                       pcfg.resolved_head_dim())
    assert not k[:, :, s:].any()
    _, collected = PM.forward(pcfg, pparams, prompt, collect_cache=True)[1:]
    if pcfg.hybrid is not None:
        for name, t in collected["mamba"].items():
            torch.testing.assert_close(cache["mamba"][name], t)
        collected = collected["attn"]
    torch.testing.assert_close(k[:, :, :s], collected["k"])
    step = make_serve_step(pcfg, tc)
    if pcfg.is_encoder_only():
        _no_decode(pcfg, pparams, cache)
        return
    out, cache2 = step(pparams, cache, batch["tokens"][:, -1],
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


def _ref_leaf(tree, path):
    """The reference leaf of a port path (``layers/3/ffn/w_up``,
    ``blocks/1/mamba/2/wz``, ``blocks/0/lns/3/ln2/scale``): the stacked
    leaf indexed by the path's list positions."""
    parts = path.split("/")
    node, index = tree, []
    for i, part in enumerate(parts):
        if i >= 2 and parts[i - 2] == "lns":     # a hybrid layer's pair
            index.append(int(part[-1]) - 1)
        elif part.isdigit():
            index.append(int(part))
        else:
            node = node[part]
    return node[tuple(index)]


def test_from_jax_params_every_leaf_bf16_bit_equal(model):
    """Every leaf of every family, bf16, bit for bit: MoE experts
    (layers, e, ...), the hybrid blocks (stacked on blocks, then on the
    block's layers of a kind, the norms also on a norm-pair axis) and the
    frontend projection."""
    rcfg, pcfg, _rparams, _pparams = model
    bf = dict(param_dtype="bfloat16", activation_dtype="bfloat16")
    rcfg, pcfg = (dataclasses.replace(rcfg, **bf),
                  dataclasses.replace(pcfg, **bf))
    tree = jax.tree.map(np.asarray,
                        RM.init_params(rcfg, jax.random.PRNGKey(2)))
    port = from_jax_params(pcfg, tree, device="cpu")
    leaves = L.tree_leaves(port)
    n_ref = sum(x.size for x in jax.tree.leaves(tree))
    assert sum(t.numel() for t in leaves.values()) == n_ref
    assert n_ref == pcfg.param_counts()[0]
    for path, t in leaves.items():
        want = _ref_leaf(tree, path)
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == want.shape, \
            path
        assert np.array_equal(t.view(torch.int16).numpy(),
                              want.view(np.int16)), path
    if pcfg.frontend is not None:
        assert "frontend/w" in leaves
    if pcfg.hybrid is not None:
        block = port["blocks"][0]
        assert [len(block[k]) for k in ("mamba", "moe", "mlp", "lns")] == \
            [3, 2, 2, 4]


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
# 5. MoE gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", MOE_CONFIGS)
def test_moe_gradients_match_reference(name):
    """The loss (cross entropy plus the summed Switch aux loss) and its
    gradient with respect to every leaf, router and experts included,
    against the reference's ``jax.grad`` within 1e-4 of each leaf's
    largest entry."""
    arch, _variant = CONFIGS[name]
    rcfg = ref_reduced_config(ref_get_config(arch))
    pcfg = reduced_config(get_config(arch))
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(11))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, pcfg.vocab_size, (2, 33)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    loss_fn = RLOOP.make_loss_fn(rcfg, RLOOP.TrainConfig())
    (_, rmetrics), rgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        rparams, jb)
    want = L.tree_leaves(from_jax_params(
        pcfg, jax.tree.map(np.asarray, rgrads), device="cpu"))
    pparams = from_jax_params(pcfg, jax.tree.map(np.asarray, rparams),
                              device="cpu")
    params = L.tree_from_leaves(pparams, L.tree_leaves(pparams),
                                trainable=True)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    grads, metrics = PLOOP.make_grad_fn(pcfg, PLOOP.TrainConfig())(params,
                                                                   batch)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(rmetrics["loss"]), rtol=2e-4)
    np.testing.assert_allclose(float(metrics["moe_aux"]),
                               float(rmetrics["moe_aux"]), rtol=2e-4)
    assert float(metrics["moe_aux"]) > 0
    assert list(grads) == list(want)
    for k in want:
        g, w = grads[k].float().numpy(), want[k].float().numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale,
                                   err_msg=k)
    assert any("router" in k and float(grads[k].abs().max()) > 0
               for k in grads)


# ---------------------------------------------------------------------------
# 6. What waits for later slices
# ---------------------------------------------------------------------------
def test_unported_parts_raise(model):
    """Every family builds, runs and trains on the CPU; what waits
    raises, naming ROADMAP: the dry-run's trees (parameter shapes and
    axes, cache axes, train-state shapes), ``input_axes``."""
    _rcfg, pcfg, _rparams, _pparams = model
    for fn in (PM.param_shapes, PM.param_axes, PM.cache_axes):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn(pcfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        input_axes(pcfg, TRAIN_4K)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_state_shapes(pcfg, TrainConfig())


def test_training_and_dist_decode_raise(model):
    """Training is ported (``tests/test_torch_training.py``); what waits
    raises: the dry-run's train-state trees and the ``dist`` decode."""
    _rcfg, pcfg, _rparams, pparams = model
    assert callable(make_train_step(pcfg, TrainConfig()))
    state = train_state_init(pcfg, 0, TrainConfig(), device="cpu")
    assert int(state["step"]) == 0
    with pytest.raises(NotImplementedError, match="dry-run"):
        train_state_shapes(pcfg, TrainConfig())
    n = 4 + (pcfg.frontend.n_prefix if pcfg.family == "vlm" else 0)
    _, cache = PM.prefill(pcfg, pparams, _torch(_batch(7, pcfg, 1, n)),
                          max_len=n + 2)
    pos = torch.tensor([n], dtype=torch.int32)
    if pcfg.is_encoder_only():
        _no_decode(pcfg, pparams, cache)
        return
    with pytest.raises(NotImplementedError, match="dist"):
        PM.decode_step(pcfg, pparams, cache,
                       torch.zeros(1, dtype=torch.int32), pos, impl="dist")


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
    """Every family's stack on the card (B6, B9 and B10 in float32) gives
    the CPU run's logits (the plain versions) within 2e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    from repro_torch.accel import kernels as K
    _rcfg, pcfg, _rparams, pparams = model
    card = copy.deepcopy(pparams).to("cuda")
    s = 70
    batch = _torch(_batch(6, pcfg, 2, s + 1))
    prompt = _cut(batch, -1) if pcfg.family != "audio" else \
        {"feats": batch["feats"][:, :s]}
    want_p, want_c = PM.prefill(pcfg, pparams, prompt, max_len=s + 2)
    K.reset_launches()
    got_p, cache = PM.prefill(pcfg, card,
                              {k: v.cuda() for k, v in prompt.items()},
                              max_len=s + 2)
    assert K.launches["flash_fwd"] == pcfg.n_attn_layers()
    torch.testing.assert_close(got_p.cpu(), want_p, rtol=2e-4, atol=2e-4)
    if pcfg.is_encoder_only():
        return
    pos = torch.full((2,), s, dtype=torch.int32)
    want_d, _ = PM.decode_step(pcfg, pparams, want_c, batch["tokens"][:, -1],
                               pos)
    got_d, _ = PM.decode_step(pcfg, card, cache,
                              batch["tokens"][:, -1].cuda(), pos.cuda())
    assert K.launches["decode"] == pcfg.n_attn_layers()
    torch.testing.assert_close(got_d.cpu(), want_d, rtol=2e-4, atol=2e-4)
