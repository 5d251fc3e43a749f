"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B]: 62L, d=2560, 40H MLA
(kv_lora=256, q_lora=768, nope 64 / rope 32 / v 64), d_ff=6400,
vocab 73448."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b", family="decoder", n_layers=62, d_model=2560,
        n_heads=40, n_kv=40, d_ff=6400, vocab=73448,
        mla=True, q_lora=768, kv_lora=256, d_nope=64, d_rope=32, d_v=64,
        tie_embeddings=True)


def reduced() -> ModelConfig:
    return config().replace(n_layers=2, d_model=64, n_heads=4, n_kv=4,
                            d_ff=128, q_lora=32, kv_lora=16, d_nope=16,
                            d_rope=8, d_v=16, vocab=512, remat="none")
