"""Model configuration — one frozen dataclass for every model family.

The same fields and defaults as the reference package's
``repro.models.config.ModelConfig``, so a configuration carries across
field for field; ``pdtype`` / ``cdtype`` are torch dtypes here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["ModelConfig"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | rwkv | griffin | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None          # default d_model // n_heads
    mlp: str = "swiglu"                     # swiglu | squared_relu | geglu | relu
    norm: str = "rmsnorm"                   # rmsnorm | layernorm
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None    # SWA (mixtral) / local attn (griffin)
    tie_embeddings: bool = True
    logit_softcap: Optional[float] = None

    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # griffin (recurrentgemma)
    rnn_width: Optional[int] = None         # d_rnn (defaults 4/3 * d_model)
    conv_width: int = 4
    attn_every: int = 3                     # 1 local-attn per N blocks (1:2)

    # encdec (seamless backbone)
    n_encoder_layers: int = 0

    # modality frontend: None | "patches" | "frames"
    frontend: Optional[str] = None
    frontend_len: int = 0                   # patches/frames prepended

    # dtypes
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # the reference's attention implementation switch (xla | pallas); the
    # dense model here always runs its plain attention
    attn_impl: str = "xla"

    moe_groups: int = 1
    unroll_layers: bool = False

    max_seq_len: int = 8192

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 128."""
        return _round_up(self.vocab, 128)

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
