"""Kernel layer: the dispatch rule, launch counters and dispatch telemetry.

**The dispatch rule.**  Every kernel entry point (``kernels/<name>/ops.py``)
looks only at where its tensors live: CUDA tensors go to the hand-written
Hopper kernel (``kernels/csrc/*.cu``), CPU tensors to the plain PyTorch
version in ``kernels/<name>/ref.py``.  There is no third way — no
environment switch, no ``try`` that falls back: a CUDA tensor either
launches the kernel or raises.

**Launch counters.**  ``LAUNCHES[name]`` is a plain integer per kernel that
the wrapper increments right where it launches the CUDA kernel (and
nowhere else), so a run can prove its main path went through the kernel.
A kernel with several instantiations also counts each one in
``VARIANT_LAUNCHES[name][variant]``; those add up to ``LAUNCHES[name]``.

**Dispatch telemetry.**  :func:`note_dispatch` counts every entry-point
call into ``kernel_dispatch_total{kernel,impl}`` with ``impl`` one of
``cuda`` / ``ref`` — the same metric as the reference package's, so a
silent plain-version path on the GPU would show.

The TPU's ``vmem_row_budget`` (VMEM residency caps for Pallas tiles) has
no counterpart here: a CUDA kernel sizes its own blocks.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

__all__ = [
    "LAUNCHES",
    "VARIANT_LAUNCHES",
    "reset_launches",
    "count_launch",
    "use_cuda_kernel",
    "note_dispatch",
]

# kernel name -> CUDA launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {
    "fused_ingest": 0, "route_rank": 0, "fold_levels": 0, "window_stats": 0,
    "signature_embed": 0, "wkv6": 0, "flash_attention": 0,
    "flash_attention_bwd": 0, "wkv6_bwd": 0,
}
# kernel name -> instantiation -> CUDA launches since the last reset
VARIANT_LAUNCHES: Dict[str, Dict[str, int]] = {
    "flash_attention": {"wgmma": 0, "mma16": 0, "f32": 0, "wide": 0},
    # B6's backward, each launch by name: bf16 ("wgmma" variant) the Δ
    # pre-pass, the dQ and dK / dV kernels and, for grouped heads, the
    # group sum; above head dim 256 ("wide") the same with wide_dq and
    # wide_dkdv; float32 the same four on the tensor cores in 3xTF32,
    # f32_wide_dq and f32_wide_dkdv above head dim 256
    "flash_attention_bwd": {"delta": 0, "dq": 0, "dkdv": 0, "reduce": 0,
                            "wide_dq": 0, "wide_dkdv": 0, "f32_delta": 0,
                            "f32_dq": 0, "f32_dkdv": 0, "f32_reduce": 0,
                            "f32_wide_dq": 0, "f32_wide_dkdv": 0},
    "wkv6": {"chunk": 0, "step": 0, "wide_chunk": 0, "wide_step": 0},
    # B7's backward, each launch by name: at head dim 64 (a smaller D
    # zero-padded) the chunks in order ("fwd") and in reverse ("rev");
    # above it the value columns split over blocks, the two sweeps
    # ("wide_fwd", "wide_rev") and the ordered sum of their partials
    # ("wide_reduce")
    "wkv6_bwd": {"fwd": 0, "rev": 0, "wide_fwd": 0, "wide_rev": 0,
                 "wide_reduce": 0},
    # B2 from keys (the Feistel walk and the rank) or from shard ids
    "route_rank": {"keys": 0, "shards": 0},
    # B5 from signatures (the ids hashed in the kernel) or from ids
    "signature_embed": {"sig": 0, "ids": 0},
    # B3 with its accumulators in registers (NW <= 2, L <= 2) or in
    # shared memory
    "window_stats": {"small": 0, "general": 0},
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for counts in VARIANT_LAUNCHES.values():
        for v in counts:
            counts[v] = 0


def count_launch(kernel: str, n: int = 1, variant: Optional[str] = None) -> None:
    """Add ``n`` device launches of ``kernel`` (a wrapper that issues
    several launches in one call counts each), and of its instantiation
    ``variant`` where it has several."""
    LAUNCHES[kernel] += n
    if variant is not None:
        VARIANT_LAUNCHES[kernel][variant] += n


def use_cuda_kernel(kernel: str, *tensors: torch.Tensor) -> bool:
    """The dispatch rule: True when every tensor is on a CUDA device (launch
    the hand kernel), False when none is (run ``ref``).  Mixed placement
    raises — a kernel never moves data between devices on its own."""
    on_cuda = [t.is_cuda for t in tensors]
    if all(on_cuda):
        return True
    if not any(on_cuda):
        return False
    raise ValueError(
        f"{kernel}: tensors on mixed devices "
        f"{sorted({str(t.device) for t in tensors})}"
    )


def note_dispatch(kernel: str, impl: str) -> None:
    """Count one entry-point call into ``kernel_dispatch_total``."""
    from repro_torch.obs.telemetry import get_telemetry

    get_telemetry().metrics.counter(
        "kernel_dispatch_total",
        "kernel entry-point dispatches by resolved implementation",
        "1",
        labels=("kernel", "impl"),
    ).inc(1.0, kernel=kernel, impl=impl)
