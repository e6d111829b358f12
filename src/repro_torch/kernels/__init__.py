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
}
# kernel name -> instantiation -> CUDA launches since the last reset
VARIANT_LAUNCHES: Dict[str, Dict[str, int]] = {
    "flash_attention": {"wgmma": 0, "mma16": 0, "simt": 0, "wide": 0},
    "wkv6": {"chunk": 0, "step": 0, "wide": 0},
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
