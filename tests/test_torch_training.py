"""The port's training path (loss, gradients, AdamW, schedules, gradient
compression, train step) against the reference package, on the CPU.

The reference initialises the weights and train states; the port loads
them with ``from_jax_params`` / ``from_jax_train_state``. Token ids and
optimizer inputs are drawn with numpy from a seed. Models are the
reduced configs in float32: qwen1.5-0.5b (QKV bias, tied embeddings),
qwen3-8b (qk-norm, MQA at that size) and its GQA-4 variant (4 layers,
d_model 128, 8 query heads over 2 KV heads, head_dim 32), and one of
each other attention family: hubert-xlarge (audio frame features,
non-causal, no decode), internvl2-2b (patch features ahead of the text,
labels over every position) and moonshot-v1-16b-a3b (MoE every layer,
its aux loss in the loss).

1. **Loss and gradients** — ``cross_entropy_loss``; the loss and every
   leaf's gradient of ``make_grad_fn`` (the port's attention through the
   ``FlashAttention`` op — B6/B7/B8's plain versions on the CPU — and
   through ``impl="ref"``) against ``jax.value_and_grad`` of the
   reference's ``make_loss_fn`` with ``impl="ref"`` and ``"pallas"``
   (interpret mode). Loss within 2e-4; gradients within 1e-4 of the
   leaf's largest entry (float32 sums in another order; the flash
   backward recomputes p from the lse).
2. **Optimizer** — ``adamw_update`` (constant and scheduled lr), the
   schedules and ``error_feedback_step`` on identical numpy inputs,
   within float32 rounding (1e-6 of the largest entry; XLA and torch may
   round a ``pow`` or fuse differently).
3. **Train step** — ``make_train_step`` with 1 and 2 microbatches,
   compression off and on, from a carried reference state. Adam's first
   step is about ``lr · g/|g|``, so a gradient within rounding of zero
   may take either sign: every weight is within 2.5·lr of the
   reference's, and all but 1 % within 1e-5; the first moments within
   1e-5 of their largest entry (under compression, a rare entry on a
   rounding boundary of its int8 grid may be one quantum apart).
   The three families above take a 2-microbatch step too.
4. **Remat and state** — ``remat="full"``, ``"dots"`` and
   ``"dots_no_batch"`` give ``"none"``'s loss and gradients, and the
   reference's under the same policy; the products each ``"dots"``
   policy saves are the reference's classes; ``train_state_init`` and
   ``from_jax_train_state``; the dry-run trees raise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.models import model as RM
from repro.optim import adamw as RADAM
from repro.optim import compress as RCOMP
from repro.optim import schedule as RSCHED
from repro.train import loop as RLOOP
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import layers as L
from repro_torch.models import model as PM
from repro_torch.models.convert import from_jax_params, from_jax_train_state
from repro_torch.optim import adamw as PADAM
from repro_torch.optim import compress as PCOMP
from repro_torch.optim import schedule as PSCHED
from repro_torch.train import loop as PLOOP


def _gqa4(cfg):
    return dataclasses.replace(cfg, arch_id="qwen3-8b-gqa4-smoke",
                               n_layers=4, d_model=128, n_heads=8,
                               n_kv_heads=2, head_dim=32, qk_norm=True)


CONFIGS = {
    "qwen1.5-0.5b": ("qwen1.5-0.5b", None),
    "qwen3-8b-mqa": ("qwen3-8b", None),
    "qwen3-8b-gqa4": ("qwen3-8b", _gqa4),
    "hubert-xlarge": ("hubert-xlarge", None),
    "internvl2-2b": ("internvl2-2b", None),
    "moonshot-v1-16b-a3b": ("moonshot-v1-16b-a3b", None),
}
FAMILIES = ("hubert-xlarge", "internvl2-2b", "moonshot-v1-16b-a3b")


def _configs(name):
    arch, variant = CONFIGS[name]
    rcfg = ref_reduced_config(ref_get_config(arch))
    pcfg = reduced_config(get_config(arch))
    if variant is not None:
        rcfg, pcfg = variant(rcfg), variant(pcfg)
    return rcfg, pcfg


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    """(reference config, port config, reference params, port params)."""
    rcfg, pcfg = _configs(request.param)
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(11))
    pparams = from_jax_params(pcfg, jax.tree.map(np.asarray, rparams),
                              device="cpu")
    return rcfg, pcfg, rparams, pparams


def _batch(seed, cfg, b, s):
    """A numpy training batch of ``s`` positions for ``cfg``'s family:
    token ids with the next token as the label; for audio ``s`` frame
    features; for vlm ``n_prefix`` patch features ahead of ``s -
    n_prefix`` token ids; with a frontend, labels drawn for every
    position."""
    rng = np.random.default_rng(seed)
    if cfg.frontend is None:
        toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    if cfg.frontend is not None:
        n_p = s if cfg.family == "audio" else cfg.frontend.n_prefix
        out["feats"] = rng.standard_normal(
            (b, n_p, cfg.frontend.feature_dim)).astype(np.float32)
    if cfg.family != "audio":
        n_t = s - out["feats"].shape[1] if "feats" in out else s
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, n_t)
                                     ).astype(np.int32)
    out["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) if v.dtype == np.float32
            else torch.from_numpy(v).long() for k, v in batch.items()}


def _port_leaves(cfg, ref_tree):
    """A reference params-shaped tree (numpy) as the port's {path: t}."""
    return L.tree_leaves(from_jax_params(cfg, jax.tree.map(np.asarray,
                                                           ref_tree),
                                         device="cpu"))


def _close_leaves(got, want, tol):
    """Every leaf within ``tol`` of the leaf's largest entry."""
    assert list(got) == list(want)
    for k in want:
        g, w = got[k].detach().float().numpy(), want[k].float().numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# 1. Loss and gradients
# ---------------------------------------------------------------------------
def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    want = RLOOP.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels))
    got = PLOOP.cross_entropy_loss(torch.from_numpy(logits),
                                   torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # bf16 logits are upcast before the logsumexp, in both
    want = RLOOP.cross_entropy_loss(jnp.asarray(logits, jnp.bfloat16),
                                    jnp.asarray(labels))
    got = PLOOP.cross_entropy_loss(
        torch.from_numpy(logits).to(torch.bfloat16),
        torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("ref_impl", ["ref", "pallas"])
def test_loss_and_gradients_match_reference(model, ref_impl):
    rcfg, pcfg, rparams, pparams = model
    nb = _batch(1, pcfg, 2, 32)
    loss_fn = RLOOP.make_loss_fn(rcfg, RLOOP.TrainConfig(impl=ref_impl))
    (_, rmetrics), rgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        rparams, _jax(nb))
    want = _port_leaves(pcfg, rgrads)
    batch = _torch(nb)
    params = L.tree_from_leaves(pparams, L.tree_leaves(pparams),
                                trainable=True)
    for impl in ("kernel", "ref"):
        grads, metrics = PLOOP.make_grad_fn(
            pcfg, PLOOP.TrainConfig(impl=impl))(params, batch)
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(rmetrics["loss"]), rtol=2e-4)
        np.testing.assert_allclose(float(metrics["moe_aux"]),
                                   float(rmetrics["moe_aux"]), rtol=2e-4)
        _close_leaves(grads, want, 1e-4)
    assert all(p.grad is None for p in params.parameters())


# ---------------------------------------------------------------------------
# 2. Optimizer
# ---------------------------------------------------------------------------
def _opt_inputs(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b": (11,), "c": (3, 4, 2)}
    draw = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    grads = {k: rng.standard_normal(s).astype(np.float32) * 0.3
             for k, s in shapes.items()}
    m = {k: rng.standard_normal(s).astype(np.float32) * 0.01
         for k, s in shapes.items()}
    v = {k: np.abs(rng.standard_normal(s)).astype(np.float32) * 1e-3
         for k, s in shapes.items()}
    return draw, grads, m, v


def _t(tree):
    return {k: torch.from_numpy(np.array(x)) for k, x in tree.items()}


def _j(tree):
    return {k: jnp.asarray(x) for k, x in tree.items()}


@pytest.mark.parametrize("count,clip,schedule", [
    (0, 1.0, False), (4, 0.5, False), (9, 100.0, True)])
def test_adamw_matches_reference(count, clip, schedule):
    params, grads, m, v = _opt_inputs(count)
    kw = dict(b1=0.9, b2=0.95, weight_decay=0.1, grad_clip_norm=clip)
    rlr = RSCHED.linear_warmup_cosine(3e-4, 5, 50) if schedule else 3e-4
    plr = PSCHED.linear_warmup_cosine(3e-4, 5, 50) if schedule else 3e-4
    rp, rs, rmet = RADAM.adamw_update(
        _j(grads), {"m": _j(m), "v": _j(v),
                    "count": jnp.asarray(count, jnp.int32)},
        _j(params), lr=rlr, **kw)
    state = {"m": _t(m), "v": _t(v),
             "count": torch.tensor(count, dtype=torch.int32)}
    before = {k: x.clone() for k, x in _t(params).items()}
    inputs = _t(params)
    pp, ps, pmet = PADAM.adamw_update(_t(grads), state, inputs, lr=plr,
                                      **kw)
    for k in params:      # out of place: the inputs are untouched
        assert torch.equal(inputs[k], before[k])
    _close_leaves(pp, _t(rp), 1e-6)
    _close_leaves(ps["m"], _t(rs["m"]), 1e-6)
    _close_leaves(ps["v"], _t(rs["v"]), 1e-6)
    assert int(ps["count"]) == int(rs["count"]) == count + 1
    for name in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(pmet[name]), float(rmet[name]),
                                   rtol=1e-6)


def test_adamw_bf16_params_round_trip_through_f32():
    params, grads, m, v = _opt_inputs(3)
    bf = {k: torch.from_numpy(x).to(torch.bfloat16)
          for k, x in params.items()}
    pp, _s, _m = PADAM.adamw_update(
        _t(grads), PADAM.adamw_init(bf), bf, lr=1e-2)
    rp, _s, _m = RADAM.adamw_update(
        _j(grads), RADAM.adamw_init({k: jnp.asarray(x, jnp.bfloat16)
                                     for k, x in params.items()}),
        {k: jnp.asarray(x, jnp.bfloat16) for k, x in params.items()},
        lr=1e-2)
    for k in params:
        assert pp[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            pp[k].float().numpy(), np.asarray(rp[k], np.float32))


@pytest.mark.parametrize("maker,args", [
    ("cosine_schedule", (3e-4, 40, 0.1)),
    ("linear_warmup_cosine", (1e-3, 10, 60, 0.05))])
def test_schedules_match_reference(maker, args):
    ref = getattr(RSCHED, maker)(*args)
    port = getattr(PSCHED, maker)(*args)
    for step in (0, 1, 5, 10, 33, 60, 75):
        np.testing.assert_allclose(
            float(port(torch.tensor(step, dtype=torch.int32))),
            float(ref(jnp.asarray(step, jnp.int32))), rtol=1e-6, atol=1e-12)


def test_error_feedback_matches_reference():
    _p, grads, ef, _v = _opt_inputs(5)
    grads["zero"] = np.zeros((4, 3), np.float32)   # the 1e-30 scale floor
    ef["zero"] = np.zeros((4, 3), np.float32)
    rg, re_ = RCOMP.error_feedback_step(_j(grads), _j(ef))
    pg, pe = PCOMP.error_feedback_step(_t(grads), _t(ef))
    _close_leaves(pg, _t(rg), 1e-6)
    _close_leaves(pe, _t(re_), 1e-6)
    q, s = PCOMP.ef_int8_compress(torch.from_numpy(grads["a"]))
    rq, rs = RCOMP.ef_int8_compress(jnp.asarray(grads["a"]))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_allclose(float(s), float(rs), rtol=1e-7)


# ---------------------------------------------------------------------------
# 3. Train step from a carried state
# ---------------------------------------------------------------------------
LR = 3e-4


@pytest.mark.parametrize("microbatches,compression", [
    (1, False), (2, False), (1, True), (2, True)])
def test_train_step_matches_reference(microbatches, compression):
    rcfg, pcfg = _configs("qwen1.5-0.5b")
    rtc = RLOOP.TrainConfig(microbatches=microbatches,
                            grad_compression=compression, learning_rate=LR)
    ptc = PLOOP.TrainConfig(microbatches=microbatches,
                            grad_compression=compression, learning_rate=LR)
    rstate = RLOOP.train_state_init(rcfg, jax.random.PRNGKey(3), rtc)
    pstate = from_jax_train_state(
        pcfg, jax.tree.map(np.asarray, rstate), device="cpu")
    nb = _batch(4, pcfg, 4, 24)
    rnew, rmet = jax.jit(RLOOP.make_train_step(rcfg, rtc))(rstate, _jax(nb))
    pnew, pmet = PLOOP.make_train_step(pcfg, ptc)(pstate, _torch(nb))
    _check_step(pcfg, rstate, pstate, rnew, rmet, pnew, pmet, compression)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_train_step_matches_reference(name):
    """One ``make_train_step`` of 2 microbatches (the audio and vlm
    families' ``feats`` split with their labels; the MoE aux loss in the
    loss) from a carried reference state, against the reference's."""
    rcfg, pcfg = _configs(name)
    rtc = RLOOP.TrainConfig(microbatches=2, learning_rate=LR)
    ptc = PLOOP.TrainConfig(microbatches=2, learning_rate=LR)
    rstate = RLOOP.train_state_init(rcfg, jax.random.PRNGKey(3), rtc)
    pstate = from_jax_train_state(
        pcfg, jax.tree.map(np.asarray, rstate), device="cpu")
    nb = _batch(4, pcfg, 4, 24)
    rnew, rmet = jax.jit(RLOOP.make_train_step(rcfg, rtc))(rstate, _jax(nb))
    pnew, pmet = PLOOP.make_train_step(pcfg, ptc)(pstate, _torch(nb))
    np.testing.assert_allclose(float(pmet["moe_aux"]),
                               float(rmet["moe_aux"]), rtol=2e-4)
    _check_step(pcfg, rstate, pstate, rnew, rmet, pnew, pmet, False)


def _check_step(pcfg, rstate, pstate, rnew, rmet, pnew, pmet, compression):
    """The port's step (``pnew``, ``pmet``) against the reference's."""
    np.testing.assert_allclose(float(pmet["loss"]), float(rmet["loss"]),
                               rtol=2e-4)
    np.testing.assert_allclose(float(pmet["grad_norm"]),
                               float(rmet["grad_norm"]), rtol=1e-4)
    assert int(pnew["step"]) == int(rnew["step"]) == 1
    assert int(pnew["opt"]["count"]) == 1
    got = L.tree_leaves(pnew["params"])
    want = _port_leaves(pcfg, rnew["params"])
    diff = np.concatenate([(got[k].detach() - want[k]).abs().ravel().numpy()
                           for k in want])
    assert diff.max() <= 2.5 * LR, diff.max()
    assert (diff > 1e-5).mean() < 0.01, (diff > 1e-5).mean()
    m_got = pnew["opt"]["m"]
    m_want = _port_leaves(pcfg, rnew["opt"]["m"])
    if not compression:
        _close_leaves(m_got, m_want, 1e-5)
    else:
        # A gradient entry within rounding of a .5 step of its int8 grid
        # may round either way: one quantum, max|m| / 127 (the largest
        # stacked leaf's scale), at a rare entry; every other entry agrees.
        d = np.concatenate([(m_got[k] - m_want[k]).abs().ravel().numpy()
                            for k in m_want])
        peak = max(float(m_want[k].abs().max()) for k in m_want)
        assert d.max() <= peak / 127 * 1.001, (d.max(), peak / 127)
        assert (d > 1e-5 * peak).mean() < 1e-3
    # the carried state is untouched (out of place)
    again = from_jax_train_state(pcfg, jax.tree.map(np.asarray, rstate),
                                 device="cpu")
    for k, t in L.tree_leaves(again["params"]).items():
        assert torch.equal(L.tree_leaves(pstate["params"])[k], t)


# ---------------------------------------------------------------------------
# 4. Remat and state
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("remat", ["full", "dots", "dots_no_batch"])
def test_remat_full_equals_none(model, remat):
    _rcfg, pcfg, _rparams, pparams = model
    batch = _torch(_batch(2, pcfg, 2, 20))
    params = L.tree_from_leaves(pparams, L.tree_leaves(pparams),
                                trainable=True)
    out = [PLOOP.make_grad_fn(pcfg, PLOOP.TrainConfig(remat=r))(params,
                                                                batch)
           for r in ("none", remat)]
    (g0, m0), (g1, m1) = out
    assert float(m0["loss"]) == float(m1["loss"])
    _close_leaves(g1, g0, 1e-6)
    with pytest.raises(ValueError, match="remat"):
        PM.forward(pcfg, params, batch, remat="everything")


@pytest.mark.parametrize("remat", ["dots", "dots_no_batch"])
def test_remat_matches_reference(model, remat):
    """The loss and gradients under a ``"dots"`` policy against the
    reference's ``jax.grad`` under the same policy (its
    ``_REMAT_POLICIES``), the oracles on both sides."""
    rcfg, pcfg, rparams, pparams = model
    nb = _batch(3, pcfg, 2, 16)
    loss_fn = RLOOP.make_loss_fn(rcfg, RLOOP.TrainConfig(remat=remat))
    (_, rmetrics), rgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        rparams, _jax(nb))
    params = L.tree_from_leaves(pparams, L.tree_leaves(pparams),
                                trainable=True)
    grads, metrics = PLOOP.make_grad_fn(
        pcfg, PLOOP.TrainConfig(remat=remat, impl="ref"))(params,
                                                          _torch(nb))
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(rmetrics["loss"]), rtol=2e-4)
    _close_leaves(grads, _port_leaves(pcfg, rgrads), 1e-4)


def test_dots_policies_save_the_reference_products():
    """The products the dispatcher shows the policies, in a MoE model's
    forward (the plain attention's own products aside: on the card B6 is
    no product the dispatcher sees): every ``x @ w`` is an ``mm``, saved
    by both policies, and the expert products a ``bmm`` with a batch of
    experts, saved by ``"dots"`` only, as the reference's
    ``checkpoint_dots`` and ``checkpoint_dots_with_no_batch_dims`` treat
    ``einsum("bsd,df")`` and ``einsum("ecd,edf")``. A ``bmm`` of one
    batch entry or with an operand broadcast along the batch (an unfolded
    ``matmul`` of an activation by a weight) has no batch dimension."""
    from torch.utils.checkpoint import CheckpointPolicy

    _rcfg, pcfg = _configs("moonshot-v1-16b-a3b")
    params = PM.init_params(pcfg, 0, device="cpu")
    params = L.tree_from_leaves(params, L.tree_leaves(params),
                                trainable=True)
    batch = _torch(_batch(5, pcfg, 2, 16))
    for remat in ("dots", "dots_no_batch"):
        seen = {}
        policy = PM.dots_policy(remat)

        def spy(ctx, op, *args, **kw):
            decision = policy(ctx, op, *args, **kw)
            if op.overloadpacket in PM._PRODUCTS and not ctx.is_recompute:
                key = (op.overloadpacket.__name__, args[0].shape[0])
                seen[key] = decision
            return decision

        orig = PM.dots_policy
        PM.dots_policy = lambda r: spy
        try:
            PLOOP.make_grad_fn(pcfg, PLOOP.TrainConfig(
                remat=remat, impl="ref"))(params, batch)
        finally:
            PM.dots_policy = orig
        save = CheckpointPolicy.MUST_SAVE
        experts = ("bmm", pcfg.moe.n_experts)
        mms = {k: v for k, v in seen.items() if k[0] == "mm"}
        assert mms and all(v == save for v in mms.values())
        assert (seen[experts] == save) == (remat == "dots")
    a = torch.randn(3, 4, 5)
    w = torch.randn(5, 6)
    for args, batched in (((a, a.transpose(1, 2)), True),
                          ((a[:1], a[:1].transpose(1, 2)), False),
                          ((a, w.expand(3, 5, 6)), False)):
        assert PM.has_batch_dims(torch.ops.aten.bmm.default, args) is batched
    assert not PM.has_batch_dims(torch.ops.aten.mm.default, (a[0], w))


def test_train_state_init_and_conversion(model):
    rcfg, pcfg, _rparams, _pparams = model
    tc = PLOOP.TrainConfig(grad_compression=True)
    state = PLOOP.train_state_init(pcfg, 0, tc, device="cpu")
    leaves = L.tree_leaves(state["params"])
    assert all(p.requires_grad for p in leaves.values())
    assert list(state["opt"]["m"]) == list(leaves) == list(state["ef"])
    assert all(float(m.abs().sum()) == 0.0 for m in state["opt"]["m"].values())
    assert int(state["step"]) == 0 and int(state["opt"]["count"]) == 0
    # the reference's state carries over bit for bit
    rstate = RLOOP.train_state_init(rcfg, jax.random.PRNGKey(5),
                                    RLOOP.TrainConfig(grad_compression=True))
    rstate["opt"]["m"] = jax.tree.map(lambda x: x + 0.5, rstate["opt"]["m"])
    carried = from_jax_train_state(pcfg, jax.tree.map(np.asarray, rstate),
                                   device="cpu")
    for name, tree in (("params", rstate["params"]),
                       ("m", rstate["opt"]["m"]), ("ef", rstate["ef"])):
        got = (L.tree_leaves(carried["params"]) if name == "params" else
               carried["opt"]["m"] if name == "m" else carried["ef"])
        for k, t in _port_leaves(pcfg, tree).items():
            assert torch.equal(got[k].detach(), t), (name, k)
    with pytest.raises(NotImplementedError, match="dry-run"):
        PLOOP.train_state_shapes(pcfg, tc)
    with pytest.raises(NotImplementedError, match="dry-run"):
        PLOOP.train_state_axes(pcfg, tc)


def test_tree_leaves_order_and_round_trip(model):
    _rcfg, pcfg, _rparams, pparams = model
    leaves = L.tree_leaves(pparams)
    keys = list(leaves)
    top = [k.split("/")[0] for k in keys]
    assert top == sorted(top) and top[0] == "embed"
    layer_keys = [k for k in keys if k.startswith("layers/")]
    assert [int(k.split("/")[1]) for k in layer_keys] == sorted(
        int(k.split("/")[1]) for k in layer_keys)
    again = L.tree_from_leaves(pparams, leaves)
    for k, t in L.tree_leaves(again).items():
        assert t.data_ptr() == leaves[k].data_ptr()   # shared storage
        assert not t.requires_grad
