"""internvl2-2b — VLM: InternViT frontend (STUB) + InternLM2-1.8B backbone.

The vision tower is a STUB per the assignment: ``input_specs`` supplies
precomputed 1024-d patch embeddings (InternViT-300M output width, 256
patches after pixel-shuffle); the backbone owns the MLP projector into
d_model and prepends the patch tokens to the text sequence.
[arXiv:2404.16821; hf]
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    rope_theta=1e6,
    frontend=FrontendConfig(kind="vision_patches", feature_dim=1024, n_prefix=256),
    source="arXiv:2404.16821",
)
