"""RecurrentGemma-2B [arXiv:2402.19427]: 26L Griffin — (rec, rec, attn)
pattern (RG-LRU width 2560 + local MQA window 2048), d=2560, 10H (kv=1),
head_dim=256, d_ff=7680 (GeGLU), vocab 256000."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="griffin", n_layers=26, d_model=2560,
        n_heads=10, n_kv=1, d_ff=7680, vocab=256000, head_dim=256,
        window=2048, lru_width=2560, embed_scale=True, tie_embeddings=True)


def reduced() -> ModelConfig:
    return config().replace(n_layers=5, d_model=64, n_heads=4, n_kv=1,
                            head_dim=16, d_ff=128, lru_width=64, window=8,
                            vocab=512, remat="none")
