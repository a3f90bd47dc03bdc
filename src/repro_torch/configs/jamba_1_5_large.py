"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 interleave with 16-expert
top-2 MoE every other layer. [arXiv:2403.19887; hf]

Hardware-adaptation note (DESIGN.md §8): the Mamba slots use our TPU-native
chunked Mamba-2/SSD block (d_state=128) rather than the paper-exact Mamba-1
selective scan — the SSD dual form is the MXU-friendly formulation.
"""
from repro_torch.configs.base import HybridConfig, ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576, period=2),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=8),
    hybrid=HybridConfig(block_len=8, attn_index=4),
    source="arXiv:2403.19887",
)
