"""Model stack: configuration, layers, caches, the dense decoder and
RWKV6."""

from repro_torch.models.config import ModelConfig

__all__ = ["ModelConfig", "build_model"]

# families of the reference package that are not ported yet
_WAITING = {"moe": "MoE", "griffin": "other families",
            "encdec": "other families"}


def build_model(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """The model of a config, weights drawn from ``seed`` on ``device``
    (the dense and rwkv families; the others raise until they are
    ported)."""
    if cfg.family == "dense":
        from repro_torch.models.transformer import DecoderLM

        return DecoderLM(cfg, seed=seed, device=device)
    if cfg.family == "rwkv":
        from repro_torch.models.rwkv6 import RWKV6LM

        return RWKV6LM(cfg, seed=seed, device=device)
    if cfg.family in _WAITING:
        raise NotImplementedError(
            f"build_model: family {cfg.family!r} is not ported yet "
            f"(ROADMAP, next slices: {_WAITING[cfg.family]})"
        )
    raise ValueError(f"unknown family {cfg.family!r}")
