"""FeatInsight online feature store in PyTorch, with hand-written CUDA
kernels for an NVIDIA Hopper GPU.

The package mirrors the layout of the JAX package ``repro`` (``core/``,
``obs/``, ``serve/``, ``kernels/<name>/{ref,ops}.py``) and computes the
same functions: its ingest state is bit-identical to the reference's and
its answers agree within the tolerances stated in the tests.  It imports
neither ``jax`` nor anything of ``repro``.

Every entry point takes a ``device`` argument defaulting to ``"cuda"``.
:func:`resolve_device` is the one place a device string becomes a
``torch.device``: asking for CUDA on a machine without a GPU raises, so
nothing silently runs on the CPU; the CPU is used only when the caller
passes ``device="cpu"`` (the tests do).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "as_tensor"]

# numpy -> torch dtype canonicalization: the reference runs with 32-bit
# JAX types, so 64-bit inputs narrow exactly as jnp.asarray narrows them
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def as_tensor(x, device: torch.device) -> torch.Tensor:
    """A request/ingest column as a tensor on ``device`` with the
    reference's canonical 32-bit dtype (float64 -> float32, int64 -> int32;
    float32 / int32 / bool pass through)."""
    t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
    t = t.to(_NARROW.get(t.dtype, t.dtype))
    return t.to(device)


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument.

    Raises ``RuntimeError`` for a CUDA device when no GPU is visible — the
    port never falls back to the CPU on its own.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA GPU is available "
                "(pass device='cpu' to run the plain PyTorch versions)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
