"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE, GQA kv=8.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=0,  # every FFN slot is MoE
    vocab_size=32064,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400, period=1),
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
