"""The port's MoE layer (``repro_torch.models.moe``) against the
reference's (``repro.models.moe``), on the CPU, in float32.

The reference's ``init_moe`` draws the weights; inputs are drawn with
numpy from a seed. Configuration: ``reduced_config(moonshot)`` (8
experts, top-2, expert width 64, swiglu) and the same with gelu experts.
Each case holds the layer's output within 2e-4 and its Switch aux loss
within 2e-4 of the reference's, and the routing exactly: the experts
each (token, slot) picks, its place in the expert's queue and whether it
is kept, against the reference's own primitives (``jax.lax.top_k`` and
the one-hot cumsum of ``moe.py:80-85``) on the same router output.

1. random inputs, swiglu and gelu experts, one call of 24 tokens and one
   of 300 (capacity 128 either way);
2. a router with two identical columns: each token's two best experts
   tie, and ``top_k`` puts the lower index first;
3. a router biased towards one expert: more than 128 (token, slot)
   pairs queue for it, the later ones are dropped, and a dropped slot
   adds nothing;
4. the capacity rule: at least 128, rounded up to a multiple of 128;
5. the backward: the gradients with respect to the input and every
   weight, with slots dropped, against ``jax.grad`` of the reference's
   layer within 2e-4 of each leaf's largest entry; computed twice, the
   same bits; and no op of the backward accumulates into an index
   (``index_add_``, ``index_put_(accumulate=True)``, ``scatter_add``,
   ``scatter_reduce``: float atomics on the card);
6. the DTensor form (the dry run's): on a one-rank gloo mesh, with the
   weights and the input as DTensors laid out by the reference's rules,
   ``moe_block`` of reduced moonshot and reduced jamba gives the plain
   form's output, aux loss and gradients bit for bit (a child process:
   the process group is global state).
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.models import moe as RMOE
from repro.models.layers import ParamFactory as RefFactory
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import moe as PMOE

TOL = 2e-4


def _configs(act: str):
    rcfg = ref_reduced_config(ref_get_config("moonshot-v1-16b-a3b"))
    pcfg = reduced_config(get_config("moonshot-v1-16b-a3b"))
    return (dataclasses.replace(rcfg, mlp_act=act),
            dataclasses.replace(pcfg, mlp_act=act))


def _params(rcfg, seed: int = 3):
    rp, _axes = RMOE.init_moe(rcfg, RefFactory(jax.random.PRNGKey(seed),
                                               jnp.float32))
    pp = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    return rp, pp


def _x(seed: int, b: int, s: int, d: int, shift: float = 0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, d)) + shift).astype(np.float32)


def _ref_routing(rcfg, rp, x):
    """The reference's routing on its own primitives (moe.py:67-85):
    (eid (t, k), pos (t·k,), keep (t·k,))."""
    m = rcfg.moe
    t = x.shape[0] * x.shape[1]
    xf = jnp.asarray(x).reshape(t, -1)
    logits = jnp.einsum("td,de->te", xf, rp["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _gate, eid = jax.lax.top_k(probs, m.top_k)
    eflat = eid.reshape(-1)
    onehot = jax.nn.one_hot(eflat, m.n_experts, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - 1) * onehot, axis=-1)
    cap = RMOE._capacity(t, rcfg)
    return np.asarray(eid), np.asarray(pos), np.asarray(pos < cap)


def _port_routing(pcfg, pp, x):
    t = x.shape[0] * x.shape[1]
    xf = torch.from_numpy(x).reshape(t, -1)
    _probs, _gate, eid = PMOE.route(pcfg, pp, xf)
    _eflat, pos, keep = PMOE.queue(pcfg, eid, PMOE.capacity(t, pcfg))
    return eid.numpy(), pos.numpy(), keep.numpy()


def _check(rcfg, pcfg, rp, pp, x):
    """Output and aux within TOL, routing equal; returns the keep mask."""
    want, want_aux = RMOE.moe_block(rcfg, rp, jnp.asarray(x))
    got, aux = PMOE.moe_block(pcfg, pp, torch.from_numpy(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=TOL,
                               atol=1e-7)
    r_eid, r_pos, r_keep = _ref_routing(rcfg, rp, x)
    p_eid, p_pos, p_keep = _port_routing(pcfg, pp, x)
    np.testing.assert_array_equal(p_eid, r_eid)
    np.testing.assert_array_equal(p_pos, r_pos)
    np.testing.assert_array_equal(p_keep, r_keep)
    return p_eid, p_keep


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("b,s", [(2, 12), (3, 100)])
def test_moe_block_matches_reference(act, b, s):
    rcfg, pcfg = _configs(act)
    rp, pp = _params(rcfg)
    x = _x(b * s, b, s, pcfg.d_model)
    _eid, keep = _check(rcfg, pcfg, rp, pp, x)
    assert keep.all()             # 2 slots a token, 128 places an expert


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_router_ties_go_to_the_lower_index(act):
    """Experts 2 and 5 share one router column, so every token's
    probabilities for them tie exactly; columns 2 and 5 are also made the
    largest, so each token's top-2 is that tied pair: the reference's
    top_k, and the port's stable sort, put expert 2 first."""
    rcfg, pcfg = _configs(act)
    rp, pp = _params(rcfg)
    rng = np.random.default_rng(7)
    router = np.array(rp["router"])
    col = np.abs(rng.standard_normal(router.shape[0])).astype(np.float32)
    router[:, 2] = router[:, 5] = col
    rp = dict(rp, router=jnp.asarray(router))
    pp = dict(pp, router=torch.from_numpy(router.copy()))
    x = np.abs(_x(11, 2, 16, pcfg.d_model))     # x · col > 0 and large
    eid, _keep = _check(rcfg, pcfg, rp, pp, x)
    assert (eid[:, 0] == 2).all() and (eid[:, 1] == 5).all()


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_overflow_drops_the_later_slots(act):
    """Every token prefers expert 6 (its router column aligned with the
    inputs' common direction): 200 tokens queue 200 slot-0 pairs for it
    against 128 places, so the pairs of tokens 128 onwards are dropped, in
    flattened (token, slot) order, exactly as the reference drops them,
    and the output matches."""
    rcfg, pcfg = _configs(act)
    rp, pp = _params(rcfg)
    router = np.array(rp["router"])
    router[:, 6] += 0.2
    rp = dict(rp, router=jnp.asarray(router))
    pp = dict(pp, router=torch.from_numpy(router.copy()))
    x = _x(12, 2, 100, pcfg.d_model, shift=1.0)
    assert PMOE.capacity(200, pcfg) == 128
    eid, keep = _check(rcfg, pcfg, rp, pp, x)
    to6 = eid.reshape(-1) == 6
    assert to6.sum() > 128
    assert keep[to6].sum() == 128 and not keep[to6][128:].any()
    assert keep[~to6].all()
    # a token whose every slot was dropped gets zeros
    dropped = ~keep.reshape(200, 2).any(axis=1)
    if dropped.any():
        got, _ = PMOE.moe_block(pcfg, pp, torch.from_numpy(x))
        assert not got.reshape(200, -1)[torch.from_numpy(dropped)].any()


def test_capacity_rule():
    rcfg, pcfg = _configs("swiglu")
    for t in (1, 4, 200, 409, 410, 1000, 8192):
        assert PMOE.capacity(t, pcfg) == RMOE._capacity(t, rcfg)
    assert PMOE.capacity(1, pcfg) == 128
    assert PMOE.capacity(1000, pcfg) % 128 == 0
    full = get_config("moonshot-v1-16b-a3b")
    assert PMOE.capacity(4, full) == 128           # a decode step
    assert PMOE.capacity(4 * 2048, full) == 1024   # the serving prefill


def test_bf16_router_product_is_cast_after():
    """The router's logits are the product in the activation type, then
    float32 (moe.py:67): in bf16 the port's probabilities equal the
    reference's to float32 rounding, not those of an f32 product."""
    rcfg, pcfg = _configs("swiglu")
    rp, pp = _params(rcfg)
    x = _x(13, 2, 16, pcfg.d_model)
    xb = jnp.asarray(x, jnp.bfloat16)
    rb = rp["router"].astype(jnp.bfloat16)
    want = jax.nn.softmax(jnp.einsum("td,de->te", xb.reshape(32, -1),
                                     rb).astype(jnp.float32), axis=-1)
    xt = torch.from_numpy(x).to(torch.bfloat16).reshape(32, -1)
    probs, _gate, _eid = PMOE.route(pcfg, {"router": pp["router"].to(
        torch.bfloat16)}, xt)
    assert probs.dtype == torch.float32
    np.testing.assert_allclose(probs.numpy(), np.asarray(want), rtol=1e-2,
                               atol=1e-3)
    f32 = torch.softmax(torch.from_numpy(x).reshape(32, -1)
                        @ pp["router"], dim=-1)
    assert not torch.equal(probs, f32)


# The backward's ops that add into an index: float atomics on the card.
ACCUMULATING = ("index_add", "scatter_add", "scatter_reduce",
                "index_reduce", "_index_put_impl_", "index_put")


class _BackwardOps:
    """The aten ops the backward runs, as ``(name, accumulate)``."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        seen = self.seen = []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                acc = kwargs.get("accumulate", args[3] if len(args) > 3
                                 and isinstance(args[3], bool) else None)
                seen.append((func.overloadpacket.__name__, acc))
                return func(*args, **kwargs)

        self.mode = Mode()


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_moe_backward_is_a_gather_and_repeats(act):
    """With slots dropped (every token prefers expert 6): the gradients of
    a weighted sum of the output plus the aux loss match the reference's
    ``jax.grad``, repeat bit for bit, and the backward accumulates into
    no index (the parent's ``index_put_``/gather backward did, through
    ``index_put_(accumulate=True)`` and ``index_add_``)."""
    rcfg, pcfg = _configs(act)
    rp, pp = _params(rcfg)
    router = np.array(rp["router"])
    router[:, 6] += 0.2
    rp = dict(rp, router=jnp.asarray(router))
    pp = {k: v.clone().requires_grad_() for k, v in
          dict(pp, router=torch.from_numpy(router.copy())).items()}
    x = _x(12, 2, 100, pcfg.d_model, shift=1.0)
    w = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)

    def ref_loss(p, xx):
        out, aux = RMOE.moe_block(rcfg, p, xx)
        return jnp.sum(out * w) + aux

    rgx, rgp = jax.grad(ref_loss, argnums=(1, 0))(rp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    leaves = [xt] + list(pp.values())
    runs = []
    for _ in range(2):
        out, aux = PMOE.moe_block(pcfg, pp, xt)
        loss = (out * torch.from_numpy(w)).sum() + aux
        ops = _BackwardOps()
        with ops.mode:
            grads = torch.autograd.grad(loss, leaves)
        runs.append(grads)
    _e, keep, _p = PMOE.queue(pcfg, PMOE.route(pcfg, pp, xt.reshape(
        -1, pcfg.d_model))[2], 128)
    assert not bool(keep.all())                # slots were dropped
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    acc = [(n, a) for n, a in ops.seen
           if any(n.startswith(x) for x in ACCUMULATING) and a is not False]
    assert not acc, acc
    want = [np.asarray(rgx)] + [np.asarray(rgp[k]) for k in pp]
    for name, g, wnt in zip(["x"] + list(pp), runs[0], want):
        scale = max(float(np.abs(wnt).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), wnt, rtol=0, atol=TOL * scale,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# 6. The DTensor form, on a one-rank gloo mesh (a child process)
# ---------------------------------------------------------------------------
ON_MESH = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch import mesh as MH
    from repro_torch.models import layers as L
    from repro_torch.models import moe as PMOE
    from repro_torch.parallel import sharding as SH
    dist.init_process_group("gloo", init_method=sys.argv[1], rank=0,
                            world_size=1)
    mesh = MH.make_mesh((1, 1), ("data", "model"), device_type="cpu")
    out = {}
    for arch in ("moonshot-v1-16b-a3b", "jamba-1.5-large-398b"):
        cfg = reduced_config(get_config(arch))
        rng = np.random.default_rng(7)
        axes = PMOE.init_moe(cfg, L.AxesFactory())
        shapes = PMOE.init_moe(cfg, L.MetaFactory(torch.float32))
        p = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape))
                                 .astype(np.float32) * 0.3)
             for k, v in shapes.items()}
        # 300 tokens leaning towards expert 0: more than its 128 slots
        # queue for it, and the later ones are dropped
        u = rng.standard_normal(cfg.d_model).astype(np.float32)
        p["router"][:, 0] = torch.from_numpy(u)
        x = torch.from_numpy((rng.standard_normal((3, 100, cfg.d_model))
                              + u).astype(np.float32))
        g = torch.from_numpy(rng.standard_normal(x.shape)
                             .astype(np.float32))

        def run(p, x, g):
            leaves = [x] + [p[k] for k in sorted(p)]
            o, aux = PMOE.moe_block(cfg, p, x)
            grads = torch.autograd.grad((o * g).sum() + aux, leaves)
            return o, aux, grads

        plain = run({k: v.clone().requires_grad_() for k, v in p.items()},
                    x.clone().requires_grad_(), g)
        with SH.use_mesh(mesh):
            pd = {k: distribute_tensor(
                      v, mesh, SH.placements(SH.physical_spec(
                          v.shape, axes[k], SH.PARAM_RULES, mesh), mesh)
                  ).detach().requires_grad_() for k, v in p.items()}
            xd = SH.lay_out(x, "batch", "seq", "embed"
                            ).detach().requires_grad_()
            gd = SH.lay_out(g, "batch", "seq", "embed")
            with implicit_replication():
                on_mesh = run(pd, xd, gd)
        full = [t.full_tensor() if isinstance(t, DTensor) else t
                for t in (on_mesh[0], on_mesh[1], *on_mesh[2])]
        want = [plain[0], plain[1], *plain[2]]
        _e, _pos, keep = PMOE.queue(cfg, PMOE.route(cfg, p, x.reshape(
            -1, cfg.d_model))[2], PMOE.capacity(300, cfg))
        out[arch] = {"dtensor": isinstance(on_mesh[0], DTensor),
                     "dropped": int((~keep).sum()),
                     "same": [bool(torch.equal(a.detach(), b.detach()))
                              for a, b in zip(full, want)],
                     "leaves": ["out", "aux", "x"] + sorted(p)}
    dist.destroy_process_group()
    print(json.dumps(out))
""")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def test_dtensor_form_gives_the_plain_forms_bits():
    env = dict(os.environ,
               PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", ON_MESH, f"tcp://localhost:{_free_port()}"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for arch, rec in got.items():
        assert rec["dtensor"], arch          # the DTensor branch ran
        assert rec["dropped"] > 0, arch
        bad = [n for n, ok in zip(rec["leaves"], rec["same"]) if not ok]
        assert not bad, (arch, bad)
