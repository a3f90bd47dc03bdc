"""Architecture registry: ``--arch <id>`` resolution, shape cells, and
reduced (smoke-test) config derivation."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import (
    ALL_SHAPES,
    FrontendConfig,
    HybridConfig,
    ModelConfig,
    MoEConfig,
    ShapeSpec,
    SSMConfig,
    applicable_shapes,
    skip_reason,
)

from repro_torch.configs.qwen1_5_0_5b import CONFIG as _QWEN15_05B
from repro_torch.configs.codeqwen1_5_7b import CONFIG as _CODEQWEN15_7B
from repro_torch.configs.qwen3_8b import CONFIG as _QWEN3_8B
from repro_torch.configs.granite_20b import CONFIG as _GRANITE_20B
from repro_torch.configs.hubert_xlarge import CONFIG as _HUBERT_XL
from repro_torch.configs.phi3_5_moe import CONFIG as _PHI35_MOE
from repro_torch.configs.moonshot_v1_16b import CONFIG as _MOONSHOT_16B
from repro_torch.configs.jamba_1_5_large import CONFIG as _JAMBA_15_LARGE
from repro_torch.configs.internvl2_2b import CONFIG as _INTERNVL2_2B
from repro_torch.configs.mamba2_2_7b import CONFIG as _MAMBA2_27B

ARCHS: Dict[str, ModelConfig] = {
    cfg.arch_id: cfg
    for cfg in (
        _QWEN15_05B,
        _CODEQWEN15_7B,
        _QWEN3_8B,
        _GRANITE_20B,
        _HUBERT_XL,
        _PHI35_MOE,
        _MOONSHOT_16B,
        _JAMBA_15_LARGE,
        _INTERNVL2_2B,
        _MAMBA2_27B,
    )
}

ARCH_IDS: Tuple[str, ...] = tuple(ARCHS.keys())


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(
            f"unknown --arch {arch_id!r}; available: {', '.join(ARCH_IDS)}"
        )
    return ARCHS[arch_id]


def get_shape(name: str) -> ShapeSpec:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}")


def all_cells(include_skipped: bool = False) -> List[Tuple[ModelConfig, ShapeSpec, Optional[str]]]:
    """The full assignment matrix: 10 archs × 4 shapes = 40 cells.

    Returns (config, shape, skip_reason) triples; skip_reason is None for
    live cells. With include_skipped=False only live cells are returned.
    """
    cells = []
    for arch_id in ARCH_IDS:
        cfg = ARCHS[arch_id]
        for shape in ALL_SHAPES:
            reason = skip_reason(cfg, shape)
            if reason is None or include_skipped:
                cells.append((cfg, shape, reason))
    return cells


# ---------------------------------------------------------------------------
# Reduced configs for CPU smoke tests: same family/topology, tiny widths.
# ---------------------------------------------------------------------------
def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Shrink a production config to a CPU-runnable config of the SAME
    family: keeps GQA ratios, MoE routing, hybrid interleave pattern, qk-norm
    and bias flags; shrinks layer count, widths, expert count, vocab."""
    n_layers = 4 if cfg.hybrid is None else cfg.hybrid.block_len
    hybrid = None
    if cfg.hybrid is not None:
        hybrid = dataclasses.replace(cfg.hybrid, block_len=4, attn_index=2)
        n_layers = 8  # two hybrid blocks

    if cfg.n_heads:
        n_heads = min(cfg.n_heads, 4)
        # preserve the GQA grouping ratio where possible
        ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
        n_kv_heads = max(1, n_heads // ratio)
    else:
        n_heads = n_kv_heads = 0

    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe,
            n_experts=min(cfg.moe.n_experts, 8),
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=64,
        )
    ssm = None
    if cfg.ssm is not None:
        ssm = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=16, n_groups=min(cfg.ssm.n_groups, 2),
            chunk_size=16,
        )
    frontend = None
    if cfg.frontend is not None:
        frontend = dataclasses.replace(
            cfg.frontend,
            feature_dim=32,
            n_prefix=4 if cfg.frontend.n_prefix else 0,
        )
    return dataclasses.replace(
        cfg,
        arch_id=cfg.arch_id + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv_heads,
        head_dim=16 if cfg.head_dim else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        moe=moe,
        ssm=ssm,
        hybrid=hybrid,
        frontend=frontend,
        param_dtype="float32",
        activation_dtype="float32",
    )


REDUCED_SHAPE_TRAIN = ShapeSpec("smoke_train", seq_len=32, global_batch=2, kind="train")
REDUCED_SHAPE_PREFILL = ShapeSpec("smoke_prefill", seq_len=32, global_batch=2, kind="prefill")
REDUCED_SHAPE_DECODE = ShapeSpec("smoke_decode", seq_len=32, global_batch=2, kind="decode")
