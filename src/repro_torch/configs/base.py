"""ModelConfig: the reference's declarative architecture description
(``repro/configs/base.py``), with the same fields and defaults, for the
port's LM serving and training paths, and the reference's step shapes
(``ShapeSpec``, ``SHAPES``).

The port runs every family of the reference: ``decoder`` (dense-GQA or
MLA attention, Mamba-2 SSD mixers, dense or MoE MLPs, leading dense
layers), ``gemma3``, ``griffin``, ``vision`` and ``encdec``;
``list_archs()`` names the ten reference architectures, all of which it
serves and trains, in the reference's registry order. ``qwen2_72b``'s
bf16 weights (145.5 GB) do not fit one 80 GB card: whole, it runs only
sharded across ranks (``runtime/sharding.py``); on one card it runs with
its depth cut.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import common


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # decoder | gemma3 | griffin | encdec | vision
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 → d_model // n_heads
    # attention
    qkv_bias: bool = False
    rope_theta: float = 1e4
    rope_theta_global: float = 0.0   # gemma3 dual-base (global layers)
    window: int = 0                  # sliding-window size (local layers)
    attn_every: int = 0              # gemma3: every k-th layer is global
    norm: str = "rmsnorm"
    softmax_scale: Optional[float] = None
    embed_scale: bool = False        # gemma-style sqrt(d_model) embed scaling
    # MLA (deepseek-v2 / minicpm3)
    mla: bool = False
    q_lora: int = 0
    kv_lora: int = 0
    d_nope: int = 0
    d_rope: int = 0
    d_v: int = 0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    first_dense: int = 0             # leading dense layers (deepseek-v2)
    dense_d_ff: int = 0              # d_ff of those dense layers
    # SSM (mamba2)
    ssm: bool = False
    d_inner: int = 0
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    # hybrid (recurrentgemma)
    lru_width: int = 0
    # enc-dec
    enc_layers: int = 0
    # vision
    cross_every: int = 0             # one cross layer leads each group
    n_img_tokens: int = 0
    # numerics / runtime
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: str = "full"              # none | dots | full
    block_kv: int = 1024
    ssd_chunk: int = 256
    moe_capacity_factor: float = 1.25

    # -- derived -------------------------------------------------------------

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return common.pad_vocab(self.vocab)

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def params_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (the reference's rule)."""
        return self.family in ("griffin",) or self.ssm or (
            self.family == "gemma3")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


ARCH_REGISTRY = [
    "dbrx_132b", "deepseek_v2_236b", "seamless_m4t_large_v2", "qwen2_72b",
    "qwen2_1_5b", "gemma3_4b", "minicpm3_4b", "recurrentgemma_2b",
    "llama_3_2_vision_11b", "mamba2_2_7b",
]


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    """Load ``repro_torch/configs/<arch>.py`` (dashes normalized)."""
    mod_name = arch.replace("-", "_").replace(".", "_")
    if mod_name not in ARCH_REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; ported archs: "
                       f"{', '.join(ARCH_REGISTRY)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.reduced() if reduced else mod.config()


def list_archs() -> Tuple[str, ...]:
    return tuple(ARCH_REGISTRY)
