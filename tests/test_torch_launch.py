"""The port's launch tooling (``repro_torch.launch``) against the
reference's, on the CPU.

1. **Roofline** — ``model_flops`` equal to the reference's for every
   architecture × shape; the terms, bound, fraction and fit of a record
   on the H100's constants; ``load_cells``, ``table``, ``pick_hillclimb``
   and ``main``.
2. **Perf** — the reference's variants, name for name, with the port's
   ``TrainConfig`` knobs and the same rule overrides; ``terms``.
3. **Meshes** — the production meshes' shapes and names and the H100
   constants.
4. **The dry run** — one cell per family on a fake (data 2, model 4)
   mesh in a child process, at the reduced config and a small shape: the
   port's argument bytes equal the reference's
   ``memory_analysis().argument_size_in_bytes`` for the same reduced
   config and mesh (the reference compiled in its own child on 8 host
   devices); every cell runs to its end (the MoE slot map's inverse
   takes its out-of-place form on DTensors); and the global FLOPs of a
   tiny dense prefill and decode equal a hand count of their matrix
   products.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.configs import ALL_SHAPES as REF_SHAPES
from repro.launch import perf as RPERF
from repro.launch import roofline as RROOF
from repro_torch.configs import ARCH_IDS
from repro_torch.launch import mesh as MH
from repro_torch.launch import perf as PERF
from repro_torch.launch import roofline as ROOF

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# 1. Roofline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_the_references(arch):
    for shape in REF_SHAPES:
        assert ROOF.model_flops(arch, shape.name) == \
            RROOF.model_flops(arch, shape.name), shape.name


def _record(arch="qwen3-8b", shape="train_4k", tag="", **mem):
    memory = {"argument_bytes": 10 * 2**30, "output_bytes": 2**30,
              "temp_bytes": 20 * 2**30, "alias_bytes": 0, "code_bytes": 0}
    memory.update(mem)
    return {"arch": arch, "shape": shape, "mesh": MH.mesh_name(False),
            "kind": "train", "tag": tag, "flops_per_device": 1e15,
            "bytes_accessed_per_device": 1e12,
            "collectives": {"bytes_by_op": {}, "counts": {},
                            "total_bytes": 9e10},
            "memory": memory, "n_devices": 256}


def test_cell_terms_on_the_h100_constants():
    c = ROOF.cell_of(_record())
    assert c.compute_s == pytest.approx(1e15 / 989e12)
    assert c.memory_s == pytest.approx((11 + 40) * 2**30 / 3.35e12)
    assert c.memory_hi_s == pytest.approx(1e12 / 3.35e12)
    assert c.collective_s == pytest.approx(9e10 / 450e9)
    assert c.bound == "compute" and c.step_s == c.compute_s
    mf = ROOF.model_flops("qwen3-8b", "train_4k")
    assert c.useful_s == pytest.approx(mf / 256 / 989e12)
    assert c.roofline_fraction == pytest.approx(c.useful_s / c.step_s)
    assert c.flops_utilization == pytest.approx(mf / (1e15 * 256))
    assert c.device_bytes == 31 * 2**30 and c.fits
    big = ROOF.cell_of(_record(temp_bytes=100 * 2**30, alias_bytes=2**30))
    assert big.device_bytes == 110 * 2**30 and not big.fits
    slow = ROOF.cell_of(_record(temp_bytes=2000 * 2**30))
    assert slow.bound == "memory"
    assert "arithmetic intensity" in ROOF.advice(slow)
    # the perf harness's terms are the roofline's
    t = PERF.terms(_record())
    assert t["compute_s"] == c.compute_s and t["memory_s"] == c.memory_s
    assert t["collective_s"] == c.collective_s and t["bound"] == c.bound
    assert t["roofline_fraction"] == pytest.approx(c.roofline_fraction)


def test_load_table_pick_and_main(tmp_path):
    recs = [_record(), _record(shape="decode_32k", temp_bytes=0),
            _record(arch="granite-20b"), _record(tag="perf-x"),
            dict(_record(shape="prefill_32k"), mesh=MH.mesh_name(True)),
            {"arch": "hubert-xlarge", "shape": "decode_32k",
             "mesh": MH.mesh_name(False), "skipped": "encoder-only"}]
    for i, r in enumerate(recs):
        (tmp_path / f"r{i}.json").write_text(json.dumps(r))
    cells = ROOF.load_cells(str(tmp_path))
    assert sorted(cells) == [("granite-20b", "train_4k"),
                             ("qwen3-8b", "decode_32k"),
                             ("qwen3-8b", "train_4k")]
    text = ROOF.table(cells)
    assert "| qwen3-8b | train_4k |" in text and "| yes |" in text
    assert "skip:" in text and "no record" in text
    assert ROOF.pick_hillclimb(cells)[-1] == ("granite-20b", "train_4k")
    csv = tmp_path / "out" / "roof.csv"
    ROOF.main(["--dir", str(tmp_path), "--csv", str(csv)])
    lines = csv.read_text().splitlines()
    assert lines[0].endswith("device_bytes,fits") and len(lines) == 4


# ---------------------------------------------------------------------------
# 2. Perf
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["train", "serve"])
def test_variants_are_the_references(kind):
    got, want = PERF.variants(kind), RPERF.variants(kind)
    assert list(got) == list(want)
    for name, (tc, act, param) in got.items():
        rtc, ract, rparam = want[name]
        assert act == ract and param == rparam, name
        for field in ("remat", "microbatches", "grad_compression"):
            assert getattr(tc, field) == getattr(rtc, field), (name, field)
        # the reference's dry run runs its oracles ("ref") unless a
        # variant asks for "dist"; the port's variants say so explicitly
        assert tc.impl == ("dist" if rtc.impl == "dist" else "ref"), name
    assert not hasattr(PERF.variants(kind)["baseline"][0], "unroll")


# ---------------------------------------------------------------------------
# 3. Meshes
# ---------------------------------------------------------------------------
def test_constants_and_mesh_names():
    assert MH.PEAK_FLOPS_BF16 == 989e12 and MH.HBM_BW == 3.35e12
    assert MH.LINK_BW == 450e9 and MH.SMEM_BYTES == 227 * 1024
    assert 79 * 2**30 < MH.HBM_BYTES <= 80e9 * 1.07
    assert MH.mesh_name(False) == "mesh32x8"
    assert MH.mesh_name(True) == "mesh2x32x8"


# ---------------------------------------------------------------------------
# 4. The dry run, in child processes
# ---------------------------------------------------------------------------
# (family, architecture, shape kind)
CELLS = [("dense", "qwen3-8b", "train"), ("moe", "phi3.5-moe-42b-a6.6b",
                                          "decode"),
         ("ssm", "mamba2-2.7b", "prefill"), ("hybrid",
                                             "jamba-1.5-large-398b",
                                             "decode"),
         ("audio", "hubert-xlarge", "train"), ("vlm", "internvl2-2b",
                                               "decode")]
# DTensor's layout choices depend on the sizes: at a batch of 2 or 4 a
# reduced model's training step meets a redistribution it does not
# support (Partial to MaskPartial in the embedding's gradient)
SHAPES = {"train": ("smoke_train", 32, 8), "prefill": ("smoke_prefill", 32, 8),
          "decode": ("smoke_decode", 32, 8)}

PORT_CHILD = textwrap.dedent("""
    import json, sys
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun as DR, mesh as MH
    from repro_torch.parallel import sharding as SH
    from repro_torch.train.loop import TrainConfig
    cells, shapes = json.loads(sys.argv[1]), json.loads(sys.argv[2])
    MH.fake_world(8)
    mesh = MH.make_mesh((2, 4), ("data", "model"), device_type="cpu")
    out = {}
    for fam, arch, kind in cells:
        name, s, b = shapes[kind]
        shape = ShapeSpec(name, s, b, kind)
        cfg = reduced_config(get_config(arch))
        try:
            rec = DR.run_cell(arch, name, False, mesh=mesh, cfg=cfg,
                              shape=shape, save=False)
            with SH.use_mesh(mesh):
                _fn, args, donated = DR.build_cell(
                    cfg, shape, mesh, TrainConfig(remat="full", impl="ref"))
            out[fam] = {"args": rec["memory"]["argument_bytes"],
                        "alias": rec["memory"]["alias_bytes"],
                        "donated": DR.local_bytes([args[i]
                                                   for i in donated]),
                        "state": DR.local_bytes(args[0])
                        if kind == "train" else None,
                        "flops": rec["flops_global"],
                        "flops_dev": rec["flops_per_device"],
                        "coll": rec["collectives"]["total_bytes"],
                        "n": rec["n_devices"]}
        except DR.CellFailed as e:
            out[fam] = {"args": e.argument_bytes, "failed": e.op}
    # the hand-count cells: a tiny dense model on a one-device mesh
    MH.fake_world(1)
    one = MH.make_mesh((1, 1), ("data", "model"), device_type="cpu")
    cfg = reduced_config(get_config("qwen3-8b"))
    for kind in ("prefill", "decode"):
        shape = ShapeSpec("hand", 16, 2, kind)
        rec = DR.run_cell("qwen3-8b", "hand", False, mesh=one, cfg=cfg,
                          shape=shape, save=False)
        out["hand_" + kind] = rec["flops_global"]
    print(json.dumps(out))
""")

REF_CHILD = textwrap.dedent("""
    import os, json, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    jax.devices()        # 8 host devices before the dry-run module sets 512
    from repro.configs import get_config, reduced_config
    from repro.configs.base import ShapeSpec
    from repro.launch import dryrun as RDR
    from repro.parallel import sharding as SH
    from repro.train.loop import TrainConfig
    cells, shapes = json.loads(sys.argv[1]), json.loads(sys.argv[2])
    from repro.launch.mesh import make_mesh
    mesh = make_mesh((2, 4), ("data", "model"))
    out = {}
    for fam, arch, kind in cells:
        name, s, b = shapes[kind]
        shape = ShapeSpec(name, s, b, kind)
        cfg = reduced_config(get_config(arch))
        tc = TrainConfig(remat="full" if kind == "train" else "none")
        with SH.use_mesh(mesh):
            fn, args, shardings, donate = RDR.build_cell(cfg, shape, mesh,
                                                         tc)
            # keep_unused: the port counts every argument it is given
            # (the vlm decode step never reads the frontend projection)
            lowered = jax.jit(fn, in_shardings=shardings,
                              donate_argnums=donate,
                              keep_unused=True).lower(*args)
        mem = lowered.compile().memory_analysis()
        out[fam] = {"args": mem.argument_size_in_bytes,
                    "alias": mem.alias_size_in_bytes}
    print(json.dumps(out))
""")


def _children(*codes):
    """Run each child (started together) on the cells; their last lines'
    JSON."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, json.dumps(CELLS), json.dumps(SHAPES)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for code in codes]
    out = []
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stderr[-3000:]
        out.append(json.loads(stdout.strip().splitlines()[-1]))
    return out


def _hand_count(cfg, b, s, kind):
    """The matrix products' FLOPs of one step of a dense model with the
    oracles: projections, scores and P·V, the MLP, and the head (the
    prefill's last position only)."""
    d, hq, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd, ff = cfg.resolved_head_dim(), cfg.d_ff
    q_len, k_len = (s, s) if kind == "prefill" else (1, s)
    t = b * q_len
    per_layer = (2 * t * d * (hq + 2 * hkv) * hd        # q, k, v
                 + 2 * 2 * b * hq * q_len * k_len * hd  # scores, P·V
                 + 2 * t * hq * hd * d                  # out projection
                 + (3 if cfg.mlp_act == "swiglu" else 2) * 2 * t * d * ff)
    return cfg.n_layers * per_layer + 2 * b * d * cfg.vocab_size


def test_dry_run_cells_match_the_reference():
    from repro_torch.configs import get_config, reduced_config

    port, ref = _children(PORT_CHILD, REF_CHILD)
    for fam, arch, kind in CELLS:
        assert port[fam]["args"] == ref[fam]["args"], (fam, port[fam],
                                                       ref[fam])
    for fam, _arch, kind in CELLS:
        # the donated arguments alias: a train cell's whole state, as the
        # reference's (XLA aliases each of its buffers to the new state),
        # a decode cell's cache, a prefill cell's nothing
        rec = port[fam]
        assert rec["alias"] == rec["donated"], (fam, rec)
        if kind == "train":
            assert rec["alias"] == rec["state"] == ref[fam]["alias"] > 0, (
                fam, rec, ref[fam])
        elif kind == "prefill":
            assert rec["alias"] == ref[fam]["alias"] == 0, (fam, rec)
    for fam, _arch, _kind in CELLS:
        rec = port[fam]
        assert "failed" not in rec, (fam, rec)
        assert rec["n"] == 8 and rec["flops"] > 0 and rec["coll"] > 0
        # each device runs at least its share of the step's math
        assert rec["flops_dev"] * rec["n"] >= rec["flops"]
    cfg = reduced_config(get_config("qwen3-8b"))
    for kind in ("prefill", "decode"):
        assert port["hand_" + kind] == _hand_count(cfg, 2, 16, kind), kind
