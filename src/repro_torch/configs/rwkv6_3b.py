"""rwkv6-3b [ssm]: Finch — attention-free, data-dependent decay.
[arXiv:2404.05892]

Shapes only: a copy of the reference package's
``repro.configs.rwkv6_3b``.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "rwkv6-3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="rwkv",
        n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
        d_ff=8960, vocab=65536, head_dim=64,
        mlp="relu", rope_theta=0.0,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, head_dim=64,
        d_ff=256, vocab=512, param_dtype="float32", compute_dtype="float32",
    )
