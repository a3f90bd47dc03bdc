"""``chip_smoke.py``'s training phase in a child process, on the CPU.

The main run takes the training phase in a fresh process (``--train``),
so that no collection during its steps walks the objects of the phases
before it (ROADMAP.md, C3). ``run_child`` echoes the child's output and
returns the JSON of its marker line, and fails for a child that exits
non-zero or prints none. ``train_path`` (what the child runs) moves what
each run has built into the collector's permanent generation before its
steps and back before the run is freed: the reduced qwen1.5-0.5b through
every run of the phase, about 20 s.
"""
import gc
import json
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config, reduced_config

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    n = torch.get_num_threads()
    torch.set_num_threads(1)     # four host threads, a tiny model
    yield chip_smoke
    torch.set_num_threads(n)


def _child(code: str):
    return [sys.executable, "-c", code]


def test_run_child_echoes_and_returns_the_marker_line(chip_smoke, capsys):
    counts = {"flash_dkv": 3, "flash_dq": 3}
    got = chip_smoke.run_child(
        _child(f"print('step 1'); print({chip_smoke.TRAIN_COUNTS!r} + "
               f"{json.dumps(json.dumps(counts))})"),
        chip_smoke.TRAIN_COUNTS, "train")
    assert got == counts
    out = capsys.readouterr().out
    assert "step 1\n" in out and chip_smoke.TRAIN_COUNTS in out


@pytest.mark.parametrize("code", [
    "import sys; print('train counts {}'); sys.exit(3)",
    "print('no counts')"])
def test_run_child_fails_without_a_clean_marker(chip_smoke, code):
    with pytest.raises(RuntimeError, match="child process exited"):
        chip_smoke.run_child(_child(code), chip_smoke.TRAIN_COUNTS, "train")


def test_forced_collection_counts_objects(chip_smoke):
    n, secs = chip_smoke.forced_collection()
    assert n > 1000 and secs >= 0.0


def test_train_path_freezes_each_run_on_cpu(chip_smoke, tmp_path,
                                                 capsys, monkeypatch):
    frozen = []
    freeze = gc.freeze

    def counted():
        frozen.append(1)
        freeze()

    monkeypatch.setattr(gc, "freeze", counted)
    cfg = reduced_config(get_config("qwen1.5-0.5b"))
    counts = chip_smoke.train_path(cfg, device="cpu", steps=2, seq=32,
                                   ckpt_root=str(tmp_path))
    assert not any(counts.values())           # plain versions: no launch
    assert len(frozen) == 4       # fault-free, bino and restart crash, resume
    assert gc.get_freeze_count() == 0, "objects left frozen"
    out = capsys.readouterr().out
    assert out.count("byte-identical to the fault-free run") == 3
    assert not list(tmp_path.iterdir())       # checkpoints removed
