"""Dispatcher for flash attention (kernel B6).

``attention(q, k, v, *, causal=True, window=None, scale=None)`` -> (B, H,
S, D) in ``q``'s dtype, for q (B, H, S, D) and k, v (B, Hkv, S, D) with
``H`` a multiple of ``Hkv``.  CUDA tensors launch the hand-written kernel
(``kernels/csrc/flash_attention.cu``); CPU tensors run
:func:`~repro_torch.kernels.flash_attention.ref.attention_ref`.  ``scale``
defaults to ``1 / sqrt(D)``.

The reference's ``impl`` (Pallas or XLA), ``block_q`` / ``block_k`` (VMEM
tile sizes) and ``interpret`` are controls of its TPU lowering and have no
counterpart: where the tensors live decides, and the kernel sizes its own
tiles.  The reference pads D to 128 lanes for its MXU; the padded lanes add
exact zeros, so the kernel takes D as it is (any D up to
:data:`MAX_HEAD_DIM`).

The kernel takes per-(b, h, s) element strides with D contiguous, so a
model passes its (B, S, H, hd) activations as ``transpose(1, 2)`` views
without a copy; the output is allocated with ``q``'s strides, so its
``transpose(1, 2)`` is contiguous again.

Tolerances (``tests/test_torch_attention.py``, ``chip_smoke.py``): the
reference's own, ``atol = rtol = 2e-5`` in float32 and ``3e-2`` in
bfloat16 (``tests/test_kernels.py``).

No gradient: the reference's kernel has no VJP, so ``attention`` raises
when autograd would record it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import count_launch, note_dispatch, use_cuda_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["attention", "launch_flash_attention", "MAX_HEAD_DIM"]

# the kernel keeps a 64 x D tile of the output in registers
MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_argtypes_set = False


def launch_flash_attention(
    q: torch.Tensor,   # (B, H, S, D), D contiguous
    k: torch.Tensor,   # (B, Hkv, S, D), D contiguous
    v: torch.Tensor,
    o: torch.Tensor,   # (B, H, S, D) out, D contiguous
    *,
    causal: bool,
    window: Optional[int],
    scale: float,
) -> None:
    """Launch the CUDA kernel: ``o`` is written on the current stream;
    raises if the launch fails."""
    global _argtypes_set
    from repro_torch.kernels.build import library

    fn = library("flash_attention").flash_attention_launch
    if not _argtypes_set:
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 12
            + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int,
                                    ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _argtypes_set = True
    B, H, S, D = q.shape
    strides = [x.stride(i) for x in (q, k, v, o) for i in range(3)]
    dev = q.device
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _DTYPES[q.dtype], B, H, k.shape[1], S, D, *strides,
        int(causal), int(window is not None),
        # a window beyond ±(S + 1) masks as ±(S + 1) does; kept in an int
        0 if window is None else max(-(S + 1), min(int(window), S + 1)),
        float(scale), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    count_launch("flash_attention")
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err}"
        )


def attention(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,  # (B, Hkv, S, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal / sliding-window GQA attention, (B, H, S, D) in ``q``'s
    dtype."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"attention: q must be (B, H, S, D) and k, v one (B, Hkv, S, D) "
            f"shape, got {[tuple(x.shape) for x in (q, k, v)]}"
        )
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, S, D) or H % Hkv:
        raise ValueError(
            f"attention: k, v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
            "(same B, S, D; H a multiple of Hkv)"
        )
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "attention: no backward (the reference's kernel has none; it "
            "comes with the training slice, ROADMAP); call under "
            "torch.inference_mode() or torch.no_grad()"
        )
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if not use_cuda_kernel("flash_attention", q, k, v):
        note_dispatch("flash_attention", "ref")
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale)
    note_dispatch("flash_attention", "cuda")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"attention: the kernel takes float32 or bfloat16 q, k, v of one "
            f"dtype, got {[x.dtype for x in (q, k, v)]}"
        )
    if D > MAX_HEAD_DIM:
        raise ValueError(
            f"attention: the kernel takes head dims up to {MAX_HEAD_DIM}, "
            f"got {D}"
        )
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    # q's strides when q is dense (a transposed view stays one), else
    # contiguous: D contiguous either way
    o = torch.empty_like(q)
    if o.numel():
        launch_flash_attention(q, k, v, o, causal=causal, window=window,
                               scale=scale)
    return o
