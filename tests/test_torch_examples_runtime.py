"""The port's runtime drivers, ``examples/train_lm_torch.py`` and
``examples/serve_torch.py``, on the CPU (the simulator's and the
quickstart's are in ``tests/test_torch_examples.py``, whose helpers
these use).

1. ``train_lm_torch``: the reference's line shapes and microbatch
   accounting under ``--steps 4 --freeze-host h02@2``; the crash run's
   losses those of the fault-free run and the resume from
   ``--checkpoint-dir`` (``chip_smoke.examples_train_lm`` at the reduced
   size).
2. ``serve_torch``: ``--chaos crash`` against its chaos-free run
   (``chip_smoke.examples_serve``); exit code 2 on a corrupted update
   and 3 on a wedge, from probes that patch the port's runtime here.
"""
import re

import torch

from test_torch_examples import (  # noqa: F401 (fixtures)
    chip_smoke,
    one_thread,
    port,
    reference,
)


# ---------------------------------------------------------------------------
# 1. train_lm
# ---------------------------------------------------------------------------
_TRAIN_LINES = [
    ("inject", re.compile(r"^  !! injecting crash of h02 during step 2$")),
    ("step", re.compile(r"^step +(\d+)  loss +[-\d.]+  wall +[\d.]+s  "
                        r"mb (\d+)/(\d+)(  restarts=\d+)?$")),
    ("recovery", re.compile(r"^      recovery: \S.*$")),
    ("blank", re.compile(r"^$")),
    ("done", re.compile(r"^done: 4 steps, (-?\d+) wasted microbatch "
                        r"executions / (\d+) needed \(([\d.]+)% overhead\)$")),
]


def _train_shape(text: str):
    """The kinds of train_lm's lines in order (recovery lines dropped:
    where a detection lands is timing), each step's (step, needed), and
    the done line's accounting checked against the step lines."""
    kinds, needed, executed = [], [], []
    done = None
    for line in text.splitlines():
        kind, m = next(((k, p.match(line)) for k, p in _TRAIN_LINES
                        if p.match(line)), (None, None))
        assert kind is not None, f"unexpected line {line!r}"
        if kind == "recovery":
            continue
        kinds.append(kind)
        if kind == "step":
            needed.append((int(m.group(1)), int(m.group(3))))
            executed.append(int(m.group(2)))
        if kind == "done":
            done = tuple(m.groups())
    need = sum(n for _s, n in needed)
    waste = sum(executed) - need
    assert done == (str(waste), str(need),
                    f"{100.0 * waste / max(need, 1):.1f}")
    return kinds, needed


def test_train_lm_lines_and_accounting_like_reference(chip_smoke,
                                                      one_thread):
    args = ("--steps", 4, "--freeze-host", "h02@2")
    got = _train_shape(port(chip_smoke, "train_lm", *args))
    want = _train_shape(reference("train_lm.py", *args))
    assert got == want
    assert want[1] == [(i, 16) for i in range(4)]


def test_train_lm_exactly_once_and_resume(chip_smoke, one_thread,
                                          tmp_path, capsys):
    total = chip_smoke.examples_train_lm("cpu", full=False,
                                         workdir=tmp_path)
    assert total == {}          # plain versions: no launch
    out = capsys.readouterr().out
    assert "the crash run's losses equal the fault-free run's" in out
    assert "resumed from the checkpoint at step 4" in out


# ---------------------------------------------------------------------------
# 2. serve
# ---------------------------------------------------------------------------
def test_serve_chaos_crash_is_exactly_once(chip_smoke, one_thread,
                                           tmp_path, capsys):
    assert chip_smoke.examples_serve("cpu", workdir=tmp_path) == {}
    assert "losses equal to the chaos-free run's" in \
        capsys.readouterr().out


def test_serve_exit_codes(chip_smoke, one_thread, monkeypatch, capsys):
    """A NaN written into the committed parameters exits 2; a step that
    wedges past its retries exits 3."""
    from repro_torch.models import layers as L
    from repro_torch.runtime import StepWedged, TrainerRuntime

    serve = chip_smoke.example_module("serve_torch")
    run = TrainerRuntime.run

    def corrupt(self, n, **kw):
        reports = run(self, n, **kw)
        leaf = next(iter(L.tree_leaves(self.state["params"]).values()))
        with torch.no_grad():
            leaf.view(-1)[0] = float("nan")
        return reports

    def wedge(self, n, **kw):
        raise StepWedged(1, "probe")

    for probe, rc, message in ((corrupt, 2, "corrupted model update"),
                               (wedge, 3, "step 1 wedged past retry")):
        monkeypatch.setattr(TrainerRuntime, "run", probe)
        assert serve.main(["--steps", "1", "--device", "cpu"]) == rc
        assert message in capsys.readouterr().err
    monkeypatch.setattr(TrainerRuntime, "run", run)
    assert serve.main(["--steps", "1", "--device", "cpu"]) == 0
    assert "ok: all committed updates finite" in capsys.readouterr().out
