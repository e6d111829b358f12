"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 1:2 pattern.
[arXiv:2402.19427]

Shapes only: a copy of the reference package's
``repro.configs.recurrentgemma_9b``.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "recurrentgemma-9b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="griffin",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
        d_ff=12288, vocab=256000, head_dim=256,
        mlp="geglu", rope_theta=10000.0, sliding_window=2048,
        rnn_width=4096, conv_width=4, attn_every=3,
        tie_embeddings=True, logit_softcap=30.0,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=8, d_model=128, n_heads=4, n_kv_heads=1, head_dim=32,
        d_ff=256, vocab=512, rnn_width=128, sliding_window=16,
        param_dtype="float32", compute_dtype="float32",
    )
