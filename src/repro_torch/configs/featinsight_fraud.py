"""The paper's own scenario config: the fraud-detection scoring model.

A small dense transformer that reads FeatInsight feature vectors (window
features and signature embeddings) — the model the online feature service
feeds in §3.3.  A copy of the reference package's
``repro.configs.featinsight_fraud``.
"""

from repro_torch.models.config import ModelConfig

ARCH_ID = "featinsight-fraud"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=8, d_model=512, n_heads=8, n_kv_heads=8,
        d_ff=2048, vocab=1024, head_dim=64,
        mlp="swiglu", rope_theta=10000.0, tie_embeddings=True,
        frontend="patches", frontend_len=64,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab=256, frontend_len=8,
        param_dtype="float32", compute_dtype="float32",
    )
