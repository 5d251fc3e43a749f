"""Llama-3.2-Vision-11B [hf:meta-llama/Llama-3.2-11B-Vision]: 40L backbone
(8 gated cross-attention layers leading groups of 5), d=4096, 32H (GQA
kv=8), d_ff=14336, vocab 128256. The vision tower is a stub: ``input_specs``
feeds precomputed patch embeddings [B, 4096, d] (per the assignment)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b", family="vision", n_layers=40,
        d_model=4096, n_heads=32, n_kv=8, d_ff=14336, vocab=128256,
        head_dim=128, rope_theta=5e5, cross_every=5, n_img_tokens=4096,
        tie_embeddings=False)


def reduced() -> ModelConfig:
    return config().replace(n_layers=5, d_model=64, n_heads=4, n_kv=2,
                            head_dim=16, d_ff=128, vocab=512, cross_every=5,
                            n_img_tokens=16, remat="none")
