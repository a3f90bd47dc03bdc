"""The port's sequence-parallel decode (``impl="dist"``) against the
reference's, on the CPU.

1. **B9's lse mode** — the plain version's ``lse=True`` against the
   reference's ``_local_attend`` (its per-shard attention, plain jnp),
   with ``valid`` 0 (o = 0, lse = −inf), 1, at the split and tile edges
   and past the chunk, GQA groups 1 to 4; its output is the serving
   mode's bits before the cast, and serving's NaN rows are unchanged.
2. **One shard** — ``dist_decode_update_attend`` on a one-rank
   ``model`` mesh (gloo) against the reference's
   ``dist_decode_update_attend`` on a ``(1,)`` jax mesh and against the
   reference's ``reference``: ``pos`` [0, 63], [5, 33], [31, 32] × kv 1,
   2, 4, within 3e-5, cache bytes equal.
3. **Four shards** — the reference's 4-shard case (b 4, h 8, kv 2, d 16,
   S 64, ``pos`` [0, 15, 16, 63]) on 4 gloo ranks in spawned CPU
   processes, against the reference's ``reference`` (which the reference
   itself skips here for want of devices), with a chunk that holds no
   key; and ``decode_step(impl="dist")`` of a reduced model over 4 ranks
   against one process.
4. **The model** — ``decode_step(impl="dist")`` of granite-20b's reduced
   config (the reference's weights through ``from_jax_params``) on the
   one-rank mesh against the reference's ``decode_step(impl="ref")`` at
   2e-4, as the reference's ``tests/test_dist_decode.py:57`` does, and
   bit for bit against the port's ``impl="kernel"``; the helpers.
5. **On the card** (marked ``cuda``) — B9's lse mode against its plain
   version.
6. **``chip_smoke.py``'s dist phase** at a narrow width on the CPU.
"""
import functools
import socket
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.kernels.decode_attention import distributed as RD
from repro.launch.mesh import make_mesh as ref_make_mesh
from repro.models import model as RM
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.decode_attention import decode_attention as DA
from repro_torch.kernels.decode_attention import distributed as D
from repro_torch.kernels.decode_attention import ops as DOPS
from repro_torch.models import model as PM
from repro_torch.models.convert import from_jax_params
from repro_torch.parallel.sharding import use_mesh

TOL = 3e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _case(b, h, kv, d, S, pos, seed=0):
    """numpy inputs from a seed: q, new_k, new_v, cache_k, cache_v, pos."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((b, h, d), (b, kv, d), (b, kv, d), (b, S, kv, d),
                        (b, S, kv, d))]
    return arrays + [np.asarray(pos, np.int32)]


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.fixture
def one_rank():
    """A one-rank gloo group and its ``model`` mesh, torn down after each
    test (the default process group is the process's own: the other tests
    of this module start theirs)."""
    mesh = D.init_decode_mesh(0, 1, f"tcp://localhost:{_free_port()}",
                              device=torch.device("cpu"))
    yield mesh
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# 1. B9's lse mode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv,group", [(1, 4), (2, 2), (4, 1)])
def test_lse_mode_matches_the_references_local_attend(kv, group):
    b, S, d = 8, 300, 16
    h = kv * group
    q, _, _, k, v, _ = _case(b, h, kv, d, S, [0] * b, seed=kv)
    valid = np.asarray([0, 1, 31, 32, 128, 129, 300, 999], np.int32)
    ro, rl = RD._local_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(np.minimum(valid, S)), d ** -0.5)
    o, lse = DA.decode_attention_plain(*_t([q, k, v, valid]), lse=True)
    assert o.dtype == lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(ro), rtol=TOL, atol=TOL)
    rl = np.asarray(rl)
    assert np.isneginf(lse[0].numpy()).all() and np.isneginf(rl[0]).all()
    assert float(o[0].abs().max()) == 0.0
    np.testing.assert_allclose(lse[1:].numpy(), rl[1:], rtol=TOL, atol=TOL)
    # serving's mode: the same rows in q's type, NaN for valid 0
    serve = DA.decode_attention_plain(*_t([q, k, v, valid]))
    assert torch.isnan(serve[0]).all()
    assert torch.equal(serve[1:], o[1:].to(serve.dtype))
    # the public entry point takes the mode too
    o2, lse2 = DA.decode_attention_fwd(*_t([q, k, v, valid]), lse=True)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)


# ---------------------------------------------------------------------------
# 2. One shard
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _ref_dist():
    """The reference's op on a (1,) mesh, jitted once (one compile per
    input shape, not one trace per call)."""
    return jax.jit(functools.partial(RD.dist_decode_update_attend,
                                     mesh=ref_make_mesh((1,), ("model",))))


@pytest.mark.parametrize("pos", [[0, 63], [5, 33], [31, 32]])
@pytest.mark.parametrize("kv", [1, 2, 4])
def test_single_shard_matches_the_reference(one_rank, pos, kv):
    arrays = _case(2, 4, kv, 16, 64, pos)
    rout, rck, rcv = _ref_dist()(*[jnp.asarray(a) for a in arrays])
    oracle, _, _ = jax.jit(RD.reference)(*[jnp.asarray(a) for a in arrays])
    q, nk, nv, ck, cv, p = _t(arrays)
    out, ck2, cv2 = D.dist_decode_update_attend(q, nk, nv, ck, cv, p,
                                                mesh=one_rank)
    assert ck2 is ck and cv2 is cv             # written in place
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(oracle), rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(ck2.numpy(), np.asarray(rck))
    np.testing.assert_array_equal(cv2.numpy(), np.asarray(rcv))
    # the port's own oracle, and decode_attention(impl="dist") on the
    # written chunk
    pout, pck, _ = D.reference(*_t(arrays))
    np.testing.assert_allclose(out.numpy(), pout.numpy(), rtol=TOL, atol=TOL)
    assert torch.equal(pck, ck2)
    with use_mesh(one_rank):
        att = DOPS.decode_attention(q, ck2, cv2, p + 1, impl="dist")
    assert torch.equal(att, out)


def test_dist_needs_a_mesh_with_the_axis():
    q, nk, nv, ck, cv, p = _t(_case(1, 2, 1, 16, 8, [3]))
    with pytest.raises(ValueError, match="mesh"):
        D.dist_decode_update_attend(q, nk, nv, ck, cv, p)
    with pytest.raises(ValueError, match="mesh"):
        DOPS.decode_attention(q, ck, cv, p + 1, impl="dist")


# ---------------------------------------------------------------------------
# 3. Four shards: spawned CPU processes, one per rank
# ---------------------------------------------------------------------------
def _rank_main(rank, world, port, results):
    torch.set_num_threads(1)
    mesh = D.init_decode_mesh(rank, world, f"tcp://localhost:{port}",
                              device=torch.device("cpu"))
    try:
        arrays = _case(4, 8, 2, 16, 64, [0, 15, 16, 63])
        q, nk, nv, ck, cv, p = _t(arrays)
        lo, hi = D.chunk_bounds(64, world, rank)
        out, ck_l, cv_l = D.dist_decode_update_attend(
            q, nk, nv, ck[:, lo:hi].clone(), cv[:, lo:hi].clone(), p,
            mesh=mesh)
        res = {"out": out.numpy(), "ck": ck_l.numpy(), "cv": cv_l.numpy()}
        # the model: a reduced config's decode over 4 ranks
        cfg = reduced_config(get_config("qwen3-8b"))
        params = PM.init_params(cfg, 3, device="cpu")
        g = torch.Generator().manual_seed(4)
        toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=g,
                             dtype=torch.int32)
        _, cache = PM.prefill(cfg, params, {"tokens": toks[:, :8]},
                              max_len=16)
        mine = D.shard_cache(cache, world, rank)
        pos = torch.full((2,), 8, dtype=torch.int32)
        logits = []
        with use_mesh(mesh):
            for step in range(3):
                lg, _ = PM.decode_step(cfg, params, mine, toks[:, 8], pos,
                                       impl="dist")
                logits.append(lg.numpy())
                pos = pos + 1
        res["logits"] = np.stack(logits)
        results.put((rank, res))
    finally:
        dist.destroy_process_group()


def test_four_shards_match_the_reference():
    world, port = 4, _free_port()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got = dict(results.get(timeout=240) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    arrays = _case(4, 8, 2, 16, 64, [0, 15, 16, 63])
    want, rck, rcv = RD.reference(*[jnp.asarray(a) for a in arrays])
    for r in range(world):
        np.testing.assert_allclose(got[r]["out"], np.asarray(want),
                                   rtol=TOL, atol=TOL)
        lo, hi = D.chunk_bounds(64, world, r)
        np.testing.assert_array_equal(got[r]["ck"], np.asarray(rck)[:, lo:hi])
        np.testing.assert_array_equal(got[r]["cv"], np.asarray(rcv)[:, lo:hi])
    # the model over 4 ranks (chunks of 4 slots: ranks 3 holds no key
    # until position 12) against one process
    cfg = reduced_config(get_config("qwen3-8b"))
    params = PM.init_params(cfg, 3, device="cpu")
    g = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=g,
                         dtype=torch.int32)
    _, cache = PM.prefill(cfg, params, {"tokens": toks[:, :8]}, max_len=16)
    pos = torch.full((2,), 8, dtype=torch.int32)
    for step in range(3):
        want, _ = PM.decode_step(cfg, params, cache, toks[:, 8], pos)
        for r in range(world):
            np.testing.assert_allclose(got[r]["logits"][step], want.numpy(),
                                       rtol=2e-4, atol=2e-4)
        pos = pos + 1


# ---------------------------------------------------------------------------
# 4. The model, and the helpers
# ---------------------------------------------------------------------------
def test_decode_step_dist_matches_the_reference(one_rank):
    rcfg = ref_reduced_config(ref_get_config("granite-20b"))
    pcfg = reduced_config(get_config("granite-20b"))
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(1))
    params = from_jax_params(pcfg, jax.tree.map(np.asarray, rparams),
                             device="cpu")
    toks = np.random.default_rng(2).integers(
        0, pcfg.vocab_size, (2, 8)).astype(np.int32)
    _, rcache = RM.prefill(rcfg, rparams, {"tokens": jnp.asarray(toks)},
                           max_len=16)
    want, _ = RM.decode_step(rcfg, rparams, rcache, jnp.asarray(toks[:, -1]),
                             jnp.full((2,), 8, jnp.int32), impl="ref")
    pt = torch.from_numpy(toks)
    pos = torch.full((2,), 8, dtype=torch.int32)
    _, cache = PM.prefill(pcfg, params, {"tokens": pt}, max_len=16)
    kernel_cache = {"attn": {k: v.clone() for k, v in cache["attn"].items()}}
    with use_mesh(one_rank):
        got, _ = PM.decode_step(pcfg, params, cache, pt[:, -1], pos,
                                impl="dist")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    # one shard: w = 1 and the denominator 1, so B9's bits
    kern, _ = PM.decode_step(pcfg, params, kernel_cache, pt[:, -1], pos)
    assert torch.equal(got, kern)
    for name in ("k", "v"):
        assert torch.equal(cache["attn"][name], kernel_cache["attn"][name])


def test_helpers():
    assert D.chunk_bounds(64, 4, 2) == (32, 48)
    with pytest.raises(ValueError, match="split"):
        D.chunk_bounds(10, 4, 0)
    cache = {"attn": {"k": torch.arange(2 * 1 * 8 * 1 * 2.).reshape(
        2, 1, 8, 1, 2), "v": torch.zeros(2, 1, 8, 1, 2)},
        "mamba": {"state": torch.ones(2, 1, 3)}}
    part = D.shard_cache(cache, 4, 1)
    assert torch.equal(part["attn"]["k"], cache["attn"]["k"][:, :, 2:4])
    assert part["attn"]["k"].is_contiguous()
    assert torch.equal(part["mamba"]["state"], cache["mamba"]["state"])
    assert part["mamba"]["state"] is not cache["mamba"]["state"]
    assert D.group_backend(4, torch.device("cpu")) == "gloo"


# ---------------------------------------------------------------------------
# 5. On the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_lse_mode_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        q, _, _, k, v, _ = _case(4, 32, 8, 128, 1000, [0] * 4, seed=5)
        q, k, v = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
        valid = torch.tensor([0, 1, 129, 1000], dtype=torch.int32)
        o, lse = DA.decode_attention_fwd(q.cuda(), k.cuda(), v.cuda(),
                                         valid.cuda(), lse=True)
        po, pl = DA.decode_attention_plain(q, k, v, valid, lse=True)
        torch.cuda.synchronize()
        assert o.dtype == torch.float32 and float(o[0].abs().max()) == 0
        assert torch.isneginf(lse[0]).all()
        np.testing.assert_allclose(o.cpu().numpy(), po.numpy(), rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(lse[1:].cpu().numpy(), pl[1:].numpy(),
                                   rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# 6. chip_smoke.py's dist phase, rehearsed on the CPU
# ---------------------------------------------------------------------------
def test_chip_smoke_dist_path_on_the_cpu():
    """The phase's three parts at a narrow width (reduced Qwen3-8B, 4
    ranks of 64 slots, 4 steps) on the CPU, where B9's plain version runs:
    its gates hold and its probes fail them."""
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    rep = chip_smoke.dist_path(narrow=True)
    ranks = rep["ranks"]
    assert ranks["a_max_abs_err"] == 0.0
    assert ranks["c_max_rel_err"] <= 1e-5          # f32 on the CPU
    assert ranks["c_probe_rel_err"] > chip_smoke.DIST_MODEL_TOL
    assert ranks["c_greedy_equal"] == 4
    assert sorted(ranks["rank_launches"]) == [0, 1, 2, 3]
