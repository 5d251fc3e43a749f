"""Qwen2-1.5B [arXiv:2407.10671]: 28L, d=1536, 12H (GQA kv=2), d_ff=8960,
vocab 151936, QKV bias, tied embeddings."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b", family="decoder", n_layers=28, d_model=1536,
        n_heads=12, n_kv=2, d_ff=8960, vocab=151936, head_dim=128,
        qkv_bias=True, rope_theta=1e6, tie_embeddings=True)


def reduced() -> ModelConfig:
    return config().replace(n_layers=2, d_model=64, n_heads=4, n_kv=2,
                            head_dim=16, d_ff=128, vocab=512, remat="none")
