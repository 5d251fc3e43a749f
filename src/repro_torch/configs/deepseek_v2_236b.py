"""DeepSeek-V2-236B [arXiv:2405.04434]: 60L, d=5120, 128H MLA
(kv_lora=512, q_lora=1536, nope 128 / rope 64 / v 128), MoE 160 routed
top-6 + 2 shared (expert d_ff=1536), first layer dense (d_ff=12288),
vocab 102400."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", family="decoder", n_layers=60, d_model=5120,
        n_heads=128, n_kv=128, d_ff=1536, vocab=102400,
        mla=True, q_lora=1536, kv_lora=512, d_nope=128, d_rope=64, d_v=128,
        n_experts=160, top_k=6, n_shared=2, first_dense=1, dense_d_ff=12288,
        tie_embeddings=False)


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=3, d_model=64, n_heads=4, n_kv=4, d_ff=48,
        q_lora=32, kv_lora=16, d_nope=16, d_rope=8, d_v=16,
        n_experts=8, top_k=2, n_shared=1, first_dense=1, dense_d_ff=128,
        vocab=512, remat="none")
