"""``chip_smoke.py``'s model-family serving paths, rehearsed on the CPU.

Each path of the card (moonshot-v1-16b-a3b for moe, the one-block
jamba-1.5-large cut for hybrid, hubert-xlarge for audio, internvl2-2b
for vlm) runs here end to end on the plain versions at a narrow width
and a short prompt: the same prefill (audio: ``forward``), greedy decode,
launch-count checks (none on the CPU), end-to-end comparison with the f32
reference, the layer-by-layer gate on the f32 reference's stream with
its MoE routing-flip share and the Mamba layers' final states, the f32
run of the encoder, and the fp8 probes. At these widths bf16 rounding
gives 0.02-0.05 of a layer's RMS and the fp8 probe 0.14-0.36, so the
layer and logit limits are 0.1 here; the card's limits are set from the
full-width runs (PERF.md).
"""
import dataclasses
import sys
from pathlib import Path

import pytest

from repro_torch.configs import get_config

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def _narrow(name: str):
    """The path's configuration at a narrow width (its family's layout
    kept: moonshot's top-6 routing, jamba's block with 4 experts, 8
    groups scaled to 2, hubert's head_dim 80 and non-causal layernorm
    encoder, internvl2's patch prefix)."""
    r = dataclasses.replace
    if name == "moe":
        base = get_config("moonshot-v1-16b-a3b")
        return r(base, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                 head_dim=32, vocab_size=1000,
                 moe=r(base.moe, n_experts=16, d_ff_expert=64))
    if name == "hybrid":
        base = get_config("jamba-1.5-large-398b")
        return r(base, n_layers=8, d_model=128, n_heads=4, n_kv_heads=1,
                 d_ff=256, vocab_size=1000,
                 moe=r(base.moe, n_experts=4, d_ff_expert=256),
                 ssm=r(base.ssm, d_state=16, head_dim=16, n_groups=2,
                       chunk_size=16))
    if name == "audio":
        base = get_config("hubert-xlarge")
        return r(base, n_layers=2, d_model=160, n_heads=2, n_kv_heads=2,
                 d_ff=256, frontend=r(base.frontend, feature_dim=32))
    base = get_config("internvl2-2b")
    return r(base, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
             d_ff=256, vocab_size=1000,
             frontend=r(base.frontend, feature_dim=32, n_prefix=8))


@pytest.mark.parametrize("name", ["moe", "hybrid", "audio", "vlm"])
def test_chip_smoke_family_path_rehearses_on_cpu(name, monkeypatch, capsys):
    cs = _chip_smoke()
    for attr, value in (("FAMILY_PROMPT", 24), ("FAMILY_MAX_LEN", 40),
                        ("FAMILY_STEPS", 6), ("FAMILY_CHECKS", (1, 3, 6)),
                        ("FAMILY_LAYER_TOL", dict.fromkeys(
                            ("moe", "hybrid", "audio", "vlm"), 0.1)),
                        ("SERVE_TOL", 0.1)):
        monkeypatch.setattr(cs, attr, value)
    cfg = _narrow(name)
    counts = cs.family_path(name, cfg, device="cpu")
    assert not any(counts.values())
    out = capsys.readouterr().out
    assert f"{name} serve: layer by layer" in out
    assert "fp8-activation probe" in out
    if name in ("moe", "hybrid"):
        assert "MoE routing" in out
    if name == "hybrid":
        assert "final states" in out
    assert "bit for bit, the layer-by-layer replay" in out
    if name == "audio":
        assert "end to end in float32" in out
        assert "decode" not in out.split("layer by layer")[1]
    else:
        assert "decode step 6" in out


@pytest.mark.parametrize("name", ["moe", "hybrid", "vlm"])
def test_family_replay_catches_a_served_cache_fault(name, monkeypatch):
    """A prefill that writes each layer's K/V one slot late (the model's
    ``_write_kv`` only; the gate's calls are untouched) serves a wrong
    cache: the replay of the timed run must refuse it."""
    from repro_torch.models import model as PM

    cs = _chip_smoke()
    for attr, value in (("FAMILY_PROMPT", 24), ("FAMILY_MAX_LEN", 40),
                        ("FAMILY_STEPS", 3), ("FAMILY_CHECKS", (1, 3))):
        monkeypatch.setattr(cs, attr, value)

    def late(kv_out, i, kv):
        s = kv["k"].shape[1]
        kv_out["k"][i, :, 1:s + 1] = kv["k"]
        kv_out["v"][i, :, 1:s + 1] = kv["v"]

    monkeypatch.setattr(PM, "_write_kv", late)
    with pytest.raises(RuntimeError, match="served state"):
        cs.family_path(name, _narrow(name), device="cpu")


def test_family_configs_at_full_width():
    """The card's configurations: hubert and internvl2 as the registry
    has them; moonshot cut to its first 16 layers (9.80 B parameters) and
    jamba to one block of 8 layers with 4 experts (16.26 B parameters,
    32.5 GB in bf16), every width kept."""
    cs = _chip_smoke()
    for name, arch in (("audio", "hubert-xlarge"), ("vlm", "internvl2-2b")):
        assert cs.family_config(name) == get_config(arch)
    moe = cs.family_config("moe")
    assert moe.n_layers == cs.MOE_SERVE_LAYERS == 16
    assert dataclasses.replace(
        moe, arch_id="moonshot-v1-16b-a3b",
        n_layers=48) == get_config("moonshot-v1-16b-a3b")
    assert round(moe.param_counts()[0] / 1e9, 2) == 9.80
    full = get_config("jamba-1.5-large-398b")
    cut = cs.family_config("hybrid")
    assert cut.n_layers == cut.hybrid.block_len == 8
    assert cut.moe.n_experts == 4 and cut.moe.top_k == full.moe.top_k
    for field in ("d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size",
                  "ssm", "hybrid"):
        assert getattr(cut, field) == getattr(full, field), field
    assert cut.moe.d_ff_expert == full.moe.d_ff_expert
    total, _active = cut.param_counts()
    assert round(total / 1e9, 2) == 16.26
    assert [c.n_attn_layers() for c in (cut,)] == [1]
    assert cut.n_mamba_layers() == 7
    assert round(get_config("moonshot-v1-16b-a3b").param_counts()[0] / 1e9,
                 2) == 28.06
