"""Configuration schema for the repro framework.

Every assigned architecture is expressed as a ``ModelConfig``. The schema is
deliberately a superset: dense GQA transformers, GShard-style MoE, Mamba-2
SSD stacks, Jamba-style hybrid interleaves, encoder-only stacks, and
modality-frontend (audio/VLM) stubs are all instances of the same dataclass,
so the model builder, sharding rules, dry-run, and runtime cost models can
treat them uniformly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Layer-block kinds (used by the hybrid interleave machinery).
# ---------------------------------------------------------------------------
ATTN = "attn"
MAMBA = "mamba"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings (GShard/Switch-style top-k routing)."""

    n_experts: int
    top_k: int
    d_ff_expert: int
    # Apply MoE every `period` layers (1 = every layer, 2 = alternate).
    period: int = 1
    # Capacity factor for the dense-dispatch (masked einsum) formulation.
    capacity_factor: float = 1.25
    # Router jitter / aux-loss weight (load balancing, Switch-style).
    router_aux_weight: float = 0.01

    def is_moe_layer(self, layer_idx: int) -> bool:
        return layer_idx % self.period == (self.period - 1)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD settings."""

    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_kernel: int = 4
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Jamba-style interleave: within each block of ``block_len`` layers,
    layer ``attn_index`` is attention and the rest are Mamba."""

    block_len: int = 8
    attn_index: int = 4  # Jamba puts attention mid-block.

    def layer_kind(self, layer_idx: int) -> str:
        return ATTN if (layer_idx % self.block_len) == self.attn_index else MAMBA


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend STUB: ``input_specs`` supplies precomputed
    frame/patch embeddings of width ``feature_dim``; the model owns only the
    projection into ``d_model``."""

    kind: str  # "audio_frames" | "vision_patches"
    feature_dim: int
    # Number of prefix embedding positions contributed by the frontend
    # (vision). For audio the whole sequence comes from the frontend.
    n_prefix: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int          # 0 for attention-free stacks
    n_kv_heads: int       # GQA group count (== n_heads for MHA, 1 for MQA)
    d_ff: int             # dense-MLP hidden width (0 if every layer is MoE/SSM)
    vocab_size: int

    head_dim: int = 0     # 0 → d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    causal: bool = True   # False for encoder-only stacks
    tie_embeddings: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    # "swiglu" (llama lineage) or "gelu" (older encoders)
    mlp_act: str = "swiglu"
    # "rmsnorm" (llama lineage) or "layernorm" (BERT/BigCode lineage)
    norm: str = "rmsnorm"

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    frontend: Optional[FrontendConfig] = None

    # Sliding-window attention width (0 = full attention).
    window: int = 0

    # dtype policy
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"

    # citation / provenance string from the assignment table
    source: str = ""

    # ------------------------------------------------------------------
    # Derived properties
    # ------------------------------------------------------------------
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.n_heads == 0:
            return 0
        return self.d_model // self.n_heads

    def layer_kind(self, layer_idx: int) -> str:
        if self.family == "ssm":
            return MAMBA
        if self.hybrid is not None:
            return self.hybrid.layer_kind(layer_idx)
        return ATTN

    def n_attn_layers(self) -> int:
        return sum(1 for i in range(self.n_layers) if self.layer_kind(i) == ATTN)

    def n_mamba_layers(self) -> int:
        return self.n_layers - self.n_attn_layers()

    def is_encoder_only(self) -> bool:
        return not self.causal

    def is_subquadratic(self) -> bool:
        """True when long-context decode (500k) is feasible: attention-free
        or hybrid stacks (the few attention layers hold the only KV)."""
        return self.family in ("ssm", "hybrid") or self.window > 0

    def moe_layer_count(self) -> int:
        if self.moe is None:
            return 0
        return sum(
            1
            for i in range(self.n_layers)
            if self.layer_kind(i) == ATTN or True  # MoE applies to FFN slots of all layers
            if self.moe.is_moe_layer(i)
        )

    # ------------------------------------------------------------------
    # Analytic parameter counts (used by roofline's 6·N·D and by the
    # runtime's state-transfer cost model). Matches models/model.py init.
    # ------------------------------------------------------------------
    def param_counts(self) -> Tuple[int, int]:
        """Returns (n_total, n_active) parameter counts, embeddings included
        in totals but excluded from the 6·N·D "active compute" count per the
        usual convention (embedding lookup is a gather, lm_head is counted)."""
        d = self.d_model
        hd = self.resolved_head_dim()
        nq, nkv = self.n_heads, self.n_kv_heads

        def attn_params() -> int:
            p = d * (nq * hd) + d * (nkv * hd) * 2 + (nq * hd) * d
            if self.qkv_bias:
                p += (nq + 2 * nkv) * hd
            if self.qk_norm:
                p += 2 * hd
            return p

        def dense_mlp_params() -> int:
            if self.d_ff == 0:
                return 0
            mult = 3 if self.mlp_act == "swiglu" else 2
            return mult * d * self.d_ff

        def moe_mlp_params() -> Tuple[int, int]:
            assert self.moe is not None
            m = self.moe
            mult = 3 if self.mlp_act == "swiglu" else 2
            per_expert = mult * d * m.d_ff_expert
            router = d * m.n_experts
            total = m.n_experts * per_expert + router
            active = m.top_k * per_expert + router
            return total, active

        def mamba_params() -> int:
            assert self.ssm is not None
            s = self.ssm
            din = s.d_inner(d)
            nh = s.n_heads(d)
            conv_dim = din + 2 * s.n_groups * s.d_state
            p = d * (2 * din + 2 * s.n_groups * s.d_state + nh)  # in_proj
            p += conv_dim * s.conv_kernel + conv_dim  # depthwise conv + bias
            p += nh * 2  # A_log, D
            p += nh  # dt_bias
            p += din  # gated-norm weight
            p += din * d  # out_proj
            return p

        total = 0
        active = 0
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            # mixer
            if kind == ATTN:
                pm = attn_params()
            else:
                pm = mamba_params()
            total += pm
            active += pm
            # ffn slot
            if self.family == "ssm":
                pf_total, pf_active = 0, 0  # pure mamba stack has no FFN slot
            elif self.moe is not None and self.moe.is_moe_layer(i):
                pf_total, pf_active = moe_mlp_params()
            else:
                pf_total = pf_active = dense_mlp_params()
            total += pf_total
            active += pf_active
            # pre-norms: attention/hybrid layers carry (ln1, ln2); a pure
            # SSM layer has no FFN slot and only ln1. LayerNorm carries a
            # bias alongside the scale; RMSNorm is scale-only.
            n_norms = 1 if self.family == "ssm" else 2
            norm_size = 2 * d if self.norm == "layernorm" else d
            total += n_norms * norm_size
            active += n_norms * norm_size

        # final norm
        final_norm = 2 * d if self.norm == "layernorm" else d
        total += final_norm
        active += final_norm
        # lm head (counted as compute); embedding table (gather, not matmul)
        total += d * self.vocab_size  # embedding
        if not self.tie_embeddings:
            total += d * self.vocab_size
        active += d * self.vocab_size  # lm-head matmul compute
        if self.frontend is not None:
            total += self.frontend.feature_dim * d
            active += self.frontend.feature_dim * d
        return total, active


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell from the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def applicable_shapes(cfg: ModelConfig) -> Tuple[ShapeSpec, ...]:
    """Shape cells that are live for this architecture (assignment rules)."""
    shapes = []
    for s in ALL_SHAPES:
        if s.is_decode and cfg.is_encoder_only():
            continue  # encoder-only: no decode step
        if s.name == "long_500k" and not cfg.is_subquadratic():
            continue  # quadratic full attention at 524k: skipped by assignment
        shapes.append(s)
    return tuple(shapes)


def skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    if shape.is_decode and cfg.is_encoder_only():
        return "encoder-only arch: no autoregressive decode step"
    if shape.name == "long_500k" and not cfg.is_subquadratic():
        return "pure full-attention arch: 524k decode requires sub-quadratic attention"
    return None
