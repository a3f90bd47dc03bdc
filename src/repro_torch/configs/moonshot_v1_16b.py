"""moonshot-v1-16b-a3b — Moonlight-style fine-grained MoE, 64 experts top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,  # every FFN slot is MoE (d_ff_expert=1408 fine-grained experts)
    vocab_size=163840,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, period=1),
    source="hf:moonshotai/Moonlight-16B-A3B",
)
