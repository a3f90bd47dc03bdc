"""granite-20b — dense code model, MQA (kv=1), llama-style. [arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    # GPT-BigCode lineage: 2-matrix GELU MLP (a 3-matrix SwiGLU would put the
    # model at 28B, contradicting the 20B name; kv=1 MQA + vocab 49152 are
    # also BigCode signatures).
    mlp_act="gelu",
    norm="layernorm",
    source="arXiv:2405.04324",
)
