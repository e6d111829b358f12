"""yi-34b [dense]: llama-arch GQA. [arXiv:2403.04652]

Shapes only: a copy of the reference package's
``repro.configs.yi_34b``.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "yi-34b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=20480, vocab=64000, head_dim=128,
        mlp="swiglu", rope_theta=5.0e6,
        tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=512, param_dtype="float32", compute_dtype="float32",
    )
