"""Qwen2-72B [arXiv:2407.10671]: 80L, d=8192, 64H (GQA kv=8), d_ff=29568,
vocab 152064, QKV bias."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b", family="decoder", n_layers=80, d_model=8192,
        n_heads=64, n_kv=8, d_ff=29568, vocab=152064, head_dim=128,
        qkv_bias=True, rope_theta=1e6, tie_embeddings=False)


def reduced() -> ModelConfig:
    return config().replace(n_layers=2, d_model=64, n_heads=4, n_kv=2,
                            head_dim=16, d_ff=160, vocab=512, remat="none")
