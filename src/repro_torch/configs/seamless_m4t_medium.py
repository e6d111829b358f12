"""seamless-m4t-medium [audio]: enc-dec transformer backbone.
[arXiv:2308.11596]

Shapes only: a copy of the reference package's
``repro.configs.seamless_m4t_medium``.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "seamless-m4t-medium"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="encdec",
        n_layers=12, n_encoder_layers=12,
        d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab=256206, head_dim=64,
        mlp="relu", norm="layernorm", rope_theta=10000.0,
        tie_embeddings=True, frontend="frames",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, n_encoder_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, head_dim=32, d_ff=256, vocab=512,
        param_dtype="float32", compute_dtype="float32",
    )
