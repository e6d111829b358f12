"""Architecture + shape registry: ``--arch <id>`` resolution and the
40-cell (arch x shape) matrix with applicability rules.

A copy of the reference package's ``repro.configs.registry``: the same
names, shapes and cells, over this package's config modules.  The skip
reasons are the reference's strings, word for word, so ``cells()`` equals
the reference's.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Tuple

from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "SHAPES", "get_config", "get_smoke_config", "cells",
           "shape_applicable", "ShapeSpec"]

ARCHS: Dict[str, str] = {
    "nemotron-4-15b": "repro_torch.configs.nemotron_4_15b",
    "qwen3-32b": "repro_torch.configs.qwen3_32b",
    "yi-34b": "repro_torch.configs.yi_34b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini_3_8b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "phi3-vision-4.2b": "repro_torch.configs.phi3_vision_4_2b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    # the paper's own scenario (extra, not in the 40-cell matrix)
    "featinsight-fraud": "repro_torch.configs.featinsight_fraud",
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# archs with sub-quadratic decode state (O(1) or O(window)) run long_500k
_SUBQUADRATIC = {"rwkv6-3b", "recurrentgemma-9b", "mixtral-8x7b"}


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(ARCHS[arch])
    return mod.config()


def get_smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(ARCHS[arch])
    return mod.smoke_config()


def shape_applicable(arch: str, shape: str) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) for one cell."""
    if shape == "long_500k" and arch not in _SUBQUADRATIC:
        return False, (
            "pure full attention: 500k-context decode would need a "
            "524288-entry dense KV cache and O(S) attention per token with "
            "no windowing in the published config (see DESIGN.md)"
        )
    return True, ""


def cells(include_skipped: bool = True) -> List[Tuple[str, str, bool, str]]:
    """The full 40-cell matrix: (arch, shape, runnable, skip_reason)."""
    out = []
    for arch in ARCHS:
        if arch == "featinsight-fraud":
            continue
        for shape in SHAPES:
            ok, reason = shape_applicable(arch, shape)
            if include_skipped or ok:
                out.append((arch, shape, ok, reason))
    return out
