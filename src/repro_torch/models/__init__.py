"""Model stack: configuration, layers, caches, and the model families —
the dense and MoE decoder, RWKV6, RecurrentGemma (griffin) and the
encoder-decoder."""

from repro_torch.models.config import ModelConfig

__all__ = ["ModelConfig", "build_model"]


def build_model(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """The model of a config, weights drawn from ``seed`` on ``device``:
    :class:`~repro_torch.models.transformer.DecoderLM` for the ``dense``
    and ``moe`` families, :class:`~repro_torch.models.rwkv6.RWKV6LM` for
    ``rwkv``, :class:`~repro_torch.models.griffin.GriffinLM` for
    ``griffin``, :class:`~repro_torch.models.encdec.EncDecLM` for
    ``encdec``; ``ValueError`` for any other family."""
    if cfg.family in ("dense", "moe"):
        from repro_torch.models.transformer import DecoderLM

        return DecoderLM(cfg, seed=seed, device=device)
    if cfg.family == "rwkv":
        from repro_torch.models.rwkv6 import RWKV6LM

        return RWKV6LM(cfg, seed=seed, device=device)
    if cfg.family == "griffin":
        from repro_torch.models.griffin import GriffinLM

        return GriffinLM(cfg, seed=seed, device=device)
    if cfg.family == "encdec":
        from repro_torch.models.encdec import EncDecLM

        return EncDecLM(cfg, seed=seed, device=device)
    raise ValueError(f"unknown family {cfg.family!r}")
