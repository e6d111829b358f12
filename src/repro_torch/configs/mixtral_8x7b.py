"""mixtral-8x7b [moe]: 8 experts top-2, sliding-window attn. [arXiv:2401.04088]

Shapes only: a copy of the reference package's
``repro.configs.mixtral_8x7b``.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "mixtral-8x7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=32000, head_dim=128,
        mlp="swiglu", rope_theta=1.0e6, sliding_window=4096,
        num_experts=8, top_k=2, capacity_factor=1.25,
        tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=128, vocab=512, num_experts=4, top_k=2, sliding_window=16,
        param_dtype="float32", compute_dtype="float32",
    )
