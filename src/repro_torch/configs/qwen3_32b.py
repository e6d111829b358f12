"""qwen3-32b [dense]: GQA + qk_norm. [hf:Qwen/Qwen3-8B scaled per assignment]

Shapes only: a copy of the reference package's
``repro.configs.qwen3_32b``.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "qwen3-32b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8,
        d_ff=25600, vocab=151936, head_dim=128,
        mlp="swiglu", qk_norm=True, rope_theta=1.0e6,
        tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=512, param_dtype="float32", compute_dtype="float32",
    )
