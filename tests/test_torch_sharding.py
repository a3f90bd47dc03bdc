"""The port's sharding rules and axes trees against the reference's, on
the CPU.

1. **Resolution** — ``physical_spec`` of ``repro_torch.parallel.sharding``
   against the reference's on JAX ``AbstractMesh`` meshes (16×16,
   2×16×16, 32×8, 1×1; the port reads the same axis names and sizes from
   a plain dict): the reference's ``tests/test_sharding.py`` cases, every
   logical axis of the three rule tables, and its hypothesis property
   (every mapped axis divides its dimension, no axis twice) with the two
   resolvers equal on every draw. The rule tables are the reference's,
   entry for entry; ``placements`` turns a spec into DTensor placements.
2. **Axes trees** — for every registry architecture's reduced config:
   ``param_axes`` against the reference's through ``convert.py`` (the
   stacked leading names dropped), ``param_shapes`` against the
   reference's ``ShapeDtypeStruct``s, and ``cache_axes``, ``input_axes``
   and ``train_state_axes`` leaf by leaf.
3. **On a mesh** — ``constrain`` and ``lay_out`` on DTensors of a small
   fake mesh, in a child process (the fake process group is global
   state): a DTensor is laid out by the act rules, a plain tensor is left
   alone, off a mesh both are the identity.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from conftest import skip_no_hypothesis
from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.models import inputs as RIN
from repro.models import model as RM
from repro.parallel import sharding as RSH
from repro.train import loop as RLOOP
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.models import convert as C
from repro_torch.models import inputs as PIN
from repro_torch.models import model as PM
from repro_torch.parallel import sharding as SH
from repro_torch.train import loop as PLOOP

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "32x8": ((32, 8), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
RULES = {"param": "PARAM_RULES", "serve": "SERVE_PARAM_RULES",
         "act": "ACT_RULES"}


def _meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), dict(zip(axes, shape))


def _ref_spec(shape, logical, rules, mesh):
    return tuple(RSH.physical_spec(shape, logical, rules, mesh))


# ---------------------------------------------------------------------------
# 1. Resolution
# ---------------------------------------------------------------------------
def test_rule_tables_are_the_references():
    for name in RULES.values():
        assert getattr(SH, name) == getattr(RSH, name), name


def test_reference_cases():
    """The reference's ``tests/test_sharding.py`` cases, port and
    reference side by side."""
    ref, port = _meshes("1x1")
    cases = [((128, 64), ("batch", "embed"),
              {"batch": "data", "embed": None}, ("data", None)),
             ((8, 8), ("batch", "embed"),
              {"batch": ("pod", "data"), "embed": None}, ("data", None)),
             ((8, 8), ("heads", "mlp"),
              {"heads": "model", "mlp": "model"}, ("model", None))]
    for shape, logical, rules, want in cases:
        assert SH.physical_spec(shape, logical, rules, port) == want
        assert _ref_spec(shape, logical, rules, ref) == want
    one = {"model": 1}
    spec = SH.physical_spec((1, 64), ("kv_heads", "head_dim"),
                            {"kv_heads": "model", "head_dim": None}, one)
    assert spec in (("model", None), (None, None))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("rules", list(RULES))
def test_every_logical_axis_resolves_as_the_reference(mesh, rules):
    """Every logical name of the table (and an unknown one, and None) on
    dimensions that divide, do not divide and are 1."""
    ref, port = _meshes(mesh)
    table = getattr(SH, RULES[rules])
    names = list(table) + ["unknown", None]
    for dims in ((4096, 151936), (128, 7), (1, 1), (512, 256), (48, 64)):
        for a in names:
            for b in names:
                logical = (a, b)
                got = SH.physical_spec(dims, logical, table, port)
                assert got == _ref_spec(dims, logical, table, ref), \
                    (dims, logical)
    # the embedding of a Qwen-sized vocabulary
    got = SH.physical_spec((4096, 151936), ("embed", "vocab"),
                           SH.PARAM_RULES, _meshes("16x16")[1])
    assert got == ("data", "model")


@skip_no_hypothesis
def test_spec_always_valid_and_equal_to_the_reference():
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @given(st.sampled_from(list(MESHES)), st.sampled_from(list(RULES)),
           st.data())
    @settings(max_examples=60, deadline=None, derandomize=True)
    def prop(mesh, rules, data):
        ref, port = _meshes(mesh)
        table = getattr(SH, RULES[rules])
        dims = data.draw(st.lists(
            st.sampled_from([1, 2, 3, 4, 6, 8, 16, 32, 128, 256, 4096]),
            min_size=1, max_size=5))
        names = data.draw(st.lists(
            st.sampled_from(["batch", "embed", "heads", "kv_heads", "mlp",
                             "vocab", "kv_seq", "expert", "expert_cap",
                             None]),
            min_size=len(dims), max_size=len(dims)))
        spec = SH.physical_spec(tuple(dims), tuple(names), table, port)
        assert spec == _ref_spec(tuple(dims), tuple(names), table, ref)
        assert len(spec) == len(dims)
        used = []
        for dim, s in zip(dims, spec):
            if s is None:
                continue
            axes = (s,) if isinstance(s, str) else s
            used += list(axes)
            assert dim % int(np.prod([port[x] for x in axes])) == 0
        assert len(used) == len(set(used))

    prop()


def test_placements_and_local_shape():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:     # what placements reads of a DeviceMesh
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 32, 8)

    spec = (("pod", "data"), None, "model")
    assert SH.placements(spec, Mesh) == (Shard(0), Shard(0), Shard(2))
    assert SH.placements((None, None), Mesh) == (Replicate(),) * 3

    class Flat:     # an axis of size 1 holds the whole tensor
        mesh_dim_names = ("data", "model")
        shape = (4, 1)

    assert SH.placements(("data", "model"), Flat) == (Shard(0), Replicate())
    assert SH.local_shape((128, 5, 64), spec, Mesh) == (2, 5, 8)
    assert SH.mesh_sizes(Mesh) == {"pod": 2, "data": 32, "model": 8}


def test_off_a_mesh_the_identity():
    x = torch.ones(4, 4)
    assert SH.constrain(x, "batch", "embed") is x
    assert SH.lay_out(x, "batch", "embed") is x
    assert SH.current_mesh() is None
    with SH.use_mesh("m", act_rules={"batch": None}):
        assert SH.current_mesh() == "m"
        assert SH._current_rules() == (SH.PARAM_RULES, {"batch": None})
        with SH.set_rules(param_rules={"embed": None}):
            assert SH.current_mesh() == "m"
            assert SH._current_rules()[0] == {"embed": None}
        assert SH.constrain(x, "batch", "embed") is x   # not a DTensor
    assert SH.current_mesh() is None


# ---------------------------------------------------------------------------
# 2. Axes trees, leaf by leaf
# ---------------------------------------------------------------------------
def _configs(arch):
    return (ref_reduced_config(ref_get_config(arch)),
            reduced_config(get_config(arch)))


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _is_axes(x):
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_trees_match_the_reference(arch):
    rcfg, pcfg = _configs(arch)
    axes = PM.param_axes(pcfg)
    assert axes == C.from_jax_axes(pcfg, RM.param_axes(rcfg))
    # shapes: the reference's ShapeDtypeStructs, the stacked axes dropped
    ref_shapes = jax.tree.map(lambda s: tuple(s.shape), RM.param_shapes(rcfg))
    ref_dtypes = {jax.tree_util.keystr(p): str(s.dtype) for p, s in
                  jax.tree_util.tree_leaves_with_path(RM.param_shapes(rcfg))}
    shapes = PM.param_shapes(pcfg)
    flat_shapes, flat_axes = _flat(shapes), _flat(axes)
    want = _flat(C.from_jax_axes(pcfg, ref_shapes))
    assert sorted(flat_shapes) == sorted(want) == sorted(flat_axes)
    for path, t in flat_shapes.items():
        assert t.device.type == "meta", path
        assert tuple(t.shape) == want[path], path
        assert len(flat_axes[path]) == t.ndim, path
        assert str(t.dtype).replace("torch.", "") in set(ref_dtypes.values())
    # the same tree as init_params builds, leaf for leaf
    params = PM.init_params(pcfg, 0, device="cpu")
    from repro_torch.models.layers import tree_leaves
    leaves = tree_leaves(params)
    assert sorted(leaves) == sorted(flat_shapes)
    for path, t in leaves.items():
        assert t.shape == flat_shapes[path].shape, path
        assert t.dtype == flat_shapes[path].dtype, path


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_input_and_state_axes_match_the_reference(arch):
    rcfg, pcfg = _configs(arch)
    if not pcfg.is_encoder_only():
        assert PM.cache_axes(pcfg) == RM.cache_axes(rcfg)
        # one name per dimension of the cache
        cache = PM.init_cache(pcfg, 2, 16, device="meta")
        SH.tree_map_axes(lambda ax, t: len(ax) == t.ndim or pytest.fail(
            str(ax)), PM.cache_axes(pcfg), cache)
    from repro_torch.configs.base import ALL_SHAPES
    from repro.configs import get_shape as ref_get_shape
    for shape in ALL_SHAPES:
        if shape.is_decode and pcfg.is_encoder_only():
            continue
        small = ShapeSpec(shape.name, 32, 2, shape.kind)
        rsmall = type(ref_get_shape(shape.name))(shape.name, 32, 2,
                                                 shape.kind)
        got = PIN.input_axes(pcfg, small)
        assert got == RIN.input_axes(rcfg, rsmall), shape.name
    tc, rtc = PLOOP.TrainConfig(), RLOOP.TrainConfig()
    for compress in (False, True):
        tc = PLOOP.TrainConfig(grad_compression=compress)
        rtc = RLOOP.TrainConfig(grad_compression=compress)
        got = PLOOP.train_state_axes(pcfg, tc)
        want = RLOOP.train_state_axes(rcfg, rtc)
        ref_params = C.from_jax_axes(pcfg, want["params"])
        assert got["params"] == ref_params
        by_path = _flat(ref_params)
        for name in ("m", "v") + (("ef",) if compress else ()):
            moments = got[name] if name == "ef" else got["opt"][name]
            assert moments == by_path, name
        assert got["opt"]["count"] == want["opt"]["count"] == ()
        assert got["step"] == want["step"] == ()
        assert ("ef" in got) == compress
        shapes = PLOOP.train_state_shapes(pcfg, tc)
        assert sorted(shapes["opt"]["m"]) == sorted(by_path)
        for path, t in shapes["opt"]["m"].items():
            assert t.dtype == torch.float32 and t.device.type == "meta"
            assert t.ndim == len(by_path[path]), path
        assert shapes["step"].shape == () and \
            shapes["step"].dtype == torch.int32


# ---------------------------------------------------------------------------
# 3. On a mesh (a child process: the fake process group is global state)
# ---------------------------------------------------------------------------
ON_MESH = textwrap.dedent("""
    import json, torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch import mesh as MH
    from repro_torch.parallel import sharding as SH
    MH.fake_world(8)
    mesh = MH.make_mesh((2, 4), ("data", "model"), device_type="cpu")
    out = {"sizes": SH.mesh_sizes(mesh)}
    x = torch.empty((8, 16, 32), device="meta")
    with SH.use_mesh(mesh):
        d = SH.lay_out(x, "batch", "seq", "heads")
        out["lay_out"] = [str(p) for p in d.placements]
        out["local"] = list(d.to_local().shape)
        r = d.redistribute(mesh, (Replicate(), Replicate()))
        c = SH.constrain(r, "batch", "seq", "heads")
        out["constrain"] = [str(p) for p in c.placements]
        out["same"] = SH.constrain(c, "batch", "seq", "heads") is c
        out["plain"] = SH.constrain(x, "batch", "seq", "heads") is x
        # not divisible: replicated
        y = SH.lay_out(torch.empty((3, 5), device="meta"), "batch", "mlp")
        out["odd"] = [str(p) for p in y.placements]
        out["is_dtensor"] = [SH.is_dtensor(d), SH.is_dtensor(x)]
    out["outside"] = SH.is_dtensor(d)
    print(json.dumps(out))
""")


def test_constrain_and_lay_out_on_a_fake_mesh():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", ON_MESH], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["sizes"] == {"data": 2, "model": 4}
    assert got["lay_out"] == ["S(0)", "S(2)"]
    assert got["local"] == [4, 16, 8]
    assert got["constrain"] == ["S(0)", "S(2)"]
    assert got["same"] and got["plain"]
    assert got["odd"] == ["R", "R"]
    assert got["is_dtensor"] == [True, False]
    assert got["outside"] is False
