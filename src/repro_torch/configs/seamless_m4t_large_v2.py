"""SeamlessM4T-large-v2 [arXiv:2308.11596]: enc-dec, 24L encoder + 24L
decoder, d=1024, 16H, d_ff=8192, vocab 256206. The speech/modality frontend
is a stub: ``input_specs`` feeds precomputed frame embeddings [B, S, d] to
the encoder (per the assignment)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2", family="encdec", n_layers=24,
        enc_layers=24, d_model=1024, n_heads=16, n_kv=16, d_ff=8192,
        vocab=256206, head_dim=64, norm="layernorm", tie_embeddings=False)


def reduced() -> ModelConfig:
    return config().replace(n_layers=2, enc_layers=2, d_model=64, n_heads=4,
                            n_kv=4, head_dim=16, d_ff=128, vocab=512,
                            remat="none")
