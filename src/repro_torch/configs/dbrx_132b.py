"""DBRX-132B [hf:databricks/dbrx-base]: 40L, d=6144, 48H (GQA kv=8),
16 experts top-4 (fine-grained), d_ff=10752/expert, vocab 100352."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="decoder", n_layers=40, d_model=6144,
        n_heads=48, n_kv=8, d_ff=10752, vocab=100352, head_dim=128,
        rope_theta=5e5, n_experts=16, top_k=4, tie_embeddings=False)


def reduced() -> ModelConfig:
    return config().replace(n_layers=2, d_model=64, n_heads=4, n_kv=2,
                            head_dim=16, d_ff=96, vocab=512, n_experts=4,
                            top_k=2, remat="none")
