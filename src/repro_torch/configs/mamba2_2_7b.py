"""Mamba2-2.7B [arXiv:2405.21060]: 64L pure-SSD blocks (attention-free),
d=2560, d_inner=5120 (80 heads × 64), state N=128, vocab 50280."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="decoder", n_layers=64, d_model=2560,
        n_heads=80, n_kv=80, d_ff=0, vocab=50280,
        ssm=True, d_inner=5120, ssm_state=128, ssm_head_dim=64, ssm_groups=1,
        tie_embeddings=True)


def reduced() -> ModelConfig:
    return config().replace(n_layers=2, d_model=64, n_heads=4, n_kv=4,
                            d_inner=128, ssm_state=16, ssm_head_dim=32,
                            vocab=512, ssd_chunk=8, remat="none")
