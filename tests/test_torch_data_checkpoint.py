"""The port's data pipeline and checkpoint manager against the reference
package, on the CPU.

1. **Data** — ``TokenDataset.batch`` byte-identical to the reference's
   over a grid of (seed, shard, offset); a resumed pipeline equals the
   original (the rollback-log property), labels are shifted tokens,
   shards are distinct streams, tokens stay in the vocabulary.
2. **Checkpoints** — the torn-write and retention cases of
   ``tests/test_data_checkpoint.py`` run on the port (which runs them
   without ``hypothesis``), plus: a torch train-state tree with bf16,
   f32 and int32 leaves round-trips bit for bit onto its device and
   dtype (bf16 as ``uint16`` bits, its dtype in the manifest);
   ``save_async`` copies every leaf before it returns; a tree of another
   structure is refused; numpy trees are readable across the two
   packages.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.checkpoint import restore_pytree as ref_restore
from repro.checkpoint import save_pytree as ref_save
from repro.data import DataState as RefDataState
from repro.data import TokenDataset as RefTokenDataset
from repro_torch.checkpoint import (CheckpointManager, restore_pytree,
                                    save_pytree)
from repro_torch.data import DataState, ShardedTokenPipeline, TokenDataset


# ---------------------------------------------------------------------------
# 1. Data pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 12345])
@pytest.mark.parametrize("vocab,seq", [(256, 32), (151936, 64)])
def test_batches_byte_identical_to_reference(seed, vocab, seq):
    port, ref = TokenDataset(vocab, seq, seed=seed), \
        RefTokenDataset(vocab, seq, seed=seed)
    for shard in (0, 3):
        for offset in (0, 1, 17):
            got, want = port.batch(shard, offset, 2), ref.batch(shard,
                                                                offset, 2)
            assert got.dtype == want.dtype == np.int32
            assert got.tobytes() == want.tobytes()


def test_data_state_matches_reference():
    st = DataState(7, 2, 4, 5)
    ref = RefDataState(7, 2, 4, 5)
    assert st.advance(3).offset == ref.advance(3).offset == 8
    assert tuple(vars(st.advance()).values()) == \
        tuple(vars(ref.advance()).values())


@pytest.mark.parametrize("seed,shard,offset", [(0, 0, 0), (3, 5, 11),
                                               (2 ** 20, 7, 50)])
def test_resume_equivalence(seed, shard, offset):
    ds = TokenDataset(vocab_size=128, seq_len=16, seed=seed)
    p1 = ShardedTokenPipeline.fresh(ds, shard, 8, batch_size=2)
    for _ in range(offset):
        p1.next()
    state = p1.state
    expected = [p1.next()["tokens"] for _ in range(4)]
    p2 = ShardedTokenPipeline.from_state(ds, state, 2)
    for want in expected:
        assert np.array_equal(p2.next()["tokens"], want)


def test_stream_properties():
    ds = TokenDataset(vocab_size=100, seq_len=64, seed=2)
    assert not np.array_equal(ds.batch(0, 0, 4), ds.batch(1, 0, 4))
    b = ds.batch(3, 7, 8)
    assert b.min() >= 0 and b.max() < 100
    p = ShardedTokenPipeline.fresh(ds, 0, 1, batch_size=2)
    out = p.next()
    assert np.array_equal(out["tokens"][:, 1:], out["labels"][:, :-1])


# ---------------------------------------------------------------------------
# 2. Checkpoints
# ---------------------------------------------------------------------------
def _tree():
    return {"w": np.arange(12.0, dtype=np.float32).reshape(3, 4),
            "nested": {"b": np.ones(5, np.float16),
                       "count": np.int32(3)}}


def _torch_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"embed": torch.randn(6, 4, generator=g).to(
                           torch.bfloat16),
                       "layers/0/ffn/w_up": torch.randn(
                           4, 8, generator=g).to(torch.bfloat16)},
            "opt": {"m": {"embed": torch.randn(6, 4, generator=g)},
                    "count": torch.tensor(3, dtype=torch.int32)},
            "step": torch.tensor(3, dtype=torch.int32)}


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.uint8), b.view(torch.uint8))


def test_roundtrip_preserves_dtype_shape(tmp_path):
    t = _tree()
    save_pytree(str(tmp_path), t, step=5)
    restored, step, _ = restore_pytree(str(tmp_path), t)
    assert step == 5
    np.testing.assert_array_equal(restored["w"], t["w"])
    assert restored["nested"]["b"].dtype == np.float16


def test_torch_tree_bf16_round_trip_bit_for_bit(tmp_path):
    tree = _torch_tree()
    path = save_pytree(str(tmp_path), tree, step=2)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    bf16 = [manifest["leaves"][f] for f in manifest["dtypes"]]
    assert sorted(bf16) == ["params/embed", "params/layers/0/ffn/w_up"]
    assert set(manifest["dtypes"].values()) == {"bfloat16"}
    # the bf16 leaves are stored as their uint16 bits
    fname = next(iter(manifest["dtypes"]))
    assert np.load(os.path.join(path, fname)).dtype == np.uint16
    like = _torch_tree(seed=1)
    restored, step, _ = restore_pytree(str(tmp_path), like)
    assert step == 2
    for key in ("embed", "layers/0/ffn/w_up"):
        assert _same_bits(restored["params"][key], tree["params"][key])
    assert _same_bits(restored["opt"]["m"]["embed"],
                      tree["opt"]["m"]["embed"])
    assert int(restored["step"]) == 3 and restored["step"].dtype == \
        torch.int32


def test_restore_refuses_another_tree(tmp_path):
    save_pytree(str(tmp_path), _torch_tree(), step=1)
    other = _torch_tree()
    other["params"]["lm_head"] = other["params"]["embed"]
    with pytest.raises(ValueError, match="wants"):
        restore_pytree(str(tmp_path), other)


def test_save_async_copies_before_returning(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _torch_tree()
    before = tree["opt"]["m"]["embed"].clone()
    mgr.save_async(tree, 4, metadata={"datastates": [{"offset": 8}]})
    tree["opt"]["m"]["embed"].add_(1.0)        # training moves on
    mgr.wait()
    restored, step, meta = mgr.restore(_torch_tree())
    assert step == 4 and meta["datastates"] == [{"offset": 8}]
    assert torch.equal(restored["opt"]["m"]["embed"], before)


def test_latest_wins_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    for s in (1, 2, 3, 4):
        t["w"] = t["w"] + 1.0
        mgr.save(t, s)
    assert mgr.latest_step() == 4
    dirs = [d for d in os.listdir(tmp_path) if d.startswith("step_")]
    assert len(dirs) == 2  # retention
    restored, step, _ = mgr.restore(t)
    assert step == 4
    np.testing.assert_array_equal(restored["w"], t["w"])


def test_shadow_race_keeps_both_until_commit(tmp_path):
    t = _tree()
    p1 = save_pytree(str(tmp_path), t, step=1, tag="primary")
    p2 = save_pytree(str(tmp_path), t, step=1, tag="shadow")
    assert p1.endswith("step_000000001")
    assert ".shadow-" in p2
    assert os.path.isdir(p1) and os.path.isdir(p2)
    # commit barrier at step 2 garbage-collects the loser
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(t, 2)
    assert not os.path.isdir(p2)
    assert os.path.isdir(p1)


def test_async_save_surfaces_and_restores(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    mgr.save_async(t, 7, metadata={"datastates": [1, 2, 3]})
    mgr.wait()
    restored, step, meta = mgr.restore(t)
    assert step == 7 and meta["datastates"] == [1, 2, 3]


def test_async_save_error_surfaces_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    os.rmdir(tmp_path / "ck")          # the writer will find no directory
    (tmp_path / "ck").write_text("not a directory")
    mgr.save_async(_tree(), 1)
    with pytest.raises(OSError):
        mgr.wait()


def test_restore_empty_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_pytree(str(tmp_path), _tree())


def test_stale_tmp_swept_on_startup(tmp_path):
    """A writer that died mid-save leaves a torn ``.tmp-`` dir; the next
    CheckpointManager must sweep it and never restore from it."""
    t = _tree()
    save_pytree(str(tmp_path), t, step=3)
    torn = os.path.join(str(tmp_path), "step_000000004.tmp-primary")
    os.makedirs(torn)
    with open(os.path.join(torn, "leaf_00000.npy"), "wb") as f:
        f.write(b"\x93NUMPY partial garbage")  # no manifest, torn leaf
    mgr = CheckpointManager(str(tmp_path))
    assert not os.path.isdir(torn)
    assert mgr.latest_step() == 3
    restored, step, _ = mgr.restore(t)
    assert step == 3
    np.testing.assert_array_equal(restored["w"], t["w"])


def test_crash_before_rename_leaves_previous_intact(tmp_path):
    """Kill the writer between leaf writes and the atomic rename: the
    previously committed step must restore bit-exact (torn dirs are
    invisible to latest_step)."""
    t = _tree()
    save_pytree(str(tmp_path), t, step=1)
    tmp = os.path.join(str(tmp_path), "step_000000002.tmp-primary")
    os.makedirs(tmp)
    np.save(os.path.join(tmp, "leaf_00000.npy"), t["w"])
    mgr = CheckpointManager(str(tmp_path))  # sweeps the orphan
    restored, step, _ = mgr.restore(t)
    assert step == 1
    np.testing.assert_array_equal(restored["w"], t["w"])


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_numpy_checkpoints_cross_packages(tmp_path, writer):
    """The layout is the reference's: a numpy tree written by either
    package restores in the other."""
    t = _tree()
    save, restore = (save_pytree, ref_restore) if writer == "port" else \
        (ref_save, restore_pytree)
    save(str(tmp_path), t, step=6, metadata={"k": 1})
    restored, step, meta = restore(str(tmp_path), t)
    assert step == 6 and meta == {"k": 1}
    np.testing.assert_array_equal(restored["w"], t["w"])
    np.testing.assert_array_equal(restored["nested"]["b"], t["nested"]["b"])
    assert int(restored["nested"]["count"]) == 3
