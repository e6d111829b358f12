"""nemotron-4-15b [dense]: GQA + squared-ReLU MLP. [arXiv:2402.16819]

Shapes only: a copy of the reference package's
``repro.configs.nemotron_4_15b``.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "nemotron-4-15b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=24576, vocab=256000, head_dim=128,
        mlp="squared_relu", qk_norm=False, rope_theta=10000.0,
        tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=512, param_dtype="float32", compute_dtype="float32",
    )
