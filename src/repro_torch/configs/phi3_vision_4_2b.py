"""phi-3-vision-4.2b [vlm]: phi3-mini backbone + CLIP patch frontend STUB.
[hf:microsoft/Phi-3-vision-128k-instruct]

Shapes only: a copy of the reference package's
``repro.configs.phi3_vision_4_2b``.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "phi3-vision-4.2b"

N_PATCHES = 576  # 24x24 CLIP-L/14-style grid (stub)


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=32064, head_dim=96,
        mlp="swiglu", rope_theta=10000.0,
        tie_embeddings=False,
        frontend="patches", frontend_len=N_PATCHES,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab=512, frontend_len=16,
        param_dtype="float32", compute_dtype="float32",
    )
