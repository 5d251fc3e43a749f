"""Gemma3-4B [hf:google/gemma-3-*]: 34L, d=2560, 8H (GQA kv=4),
head_dim=256, d_ff=10240, vocab 262144. 5:1 local:global sliding-window
pattern (window 1024; every 6th layer global), dual RoPE base
(10k local / 1M global), 128k context."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b", family="gemma3", n_layers=34, d_model=2560,
        n_heads=8, n_kv=4, d_ff=10240, vocab=262144, head_dim=256,
        window=1024, attn_every=6, rope_theta=1e4, rope_theta_global=1e6,
        embed_scale=True, tie_embeddings=True)


def reduced() -> ModelConfig:
    return config().replace(n_layers=6, d_model=64, n_heads=4, n_kv=2,
                            head_dim=16, d_ff=128, vocab=512, window=8,
                            remat="none")
