"""phi3-mini-3.8b [dense]: RoPE SwiGLU GQA (kv=32 == MHA). [arXiv:2404.14219]

Shapes only: a copy of the reference package's
``repro.configs.phi3_mini_3_8b``.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "phi3-mini-3.8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=32064, head_dim=96,
        mlp="swiglu", rope_theta=10000.0,
        tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab=512, param_dtype="float32", compute_dtype="float32",
    )
