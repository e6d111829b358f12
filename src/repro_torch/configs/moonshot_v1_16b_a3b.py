"""moonshot-v1-16b-a3b [moe]: kimi/moonlight, 64 experts top-6.
[hf:moonshotai/Moonlight-16B-A3B]

Shapes only: a copy of the reference package's
``repro.configs.moonshot_v1_16b_a3b``.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "moonshot-v1-16b-a3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab=163840, head_dim=128,
        mlp="swiglu", rope_theta=50000.0,
        num_experts=64, top_k=6, capacity_factor=1.3,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=64, vocab=512, num_experts=8, top_k=2,
        param_dtype="float32", compute_dtype="float32",
    )
