"""hubert-xlarge — encoder-only audio transformer (wav2vec2 arch).

The conv waveform frontend is a STUB per the assignment: ``input_specs``
supplies precomputed 512-d frame features (the conv-stem output width in
the wav2vec2/HuBERT lineage); the model owns the 512→1280 projection.
Output head predicts the 504 k-means target units. [arXiv:2106.07447]
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    causal=False,  # encoder-only
    mlp_act="gelu",
    norm="layernorm",
    frontend=FrontendConfig(kind="audio_frames", feature_dim=512),
    source="arXiv:2106.07447",
)
