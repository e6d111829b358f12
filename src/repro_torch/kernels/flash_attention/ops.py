"""Dispatcher for flash attention (kernel B6).

``attention(q, k, v, *, causal=True, window=None, scale=None)`` -> (B, H,
S, D) in ``q``'s dtype, for q (B, H, S, D) and k, v (B, Hkv, S, D) with
``H`` a multiple of ``Hkv``.  CUDA tensors launch the hand-written kernel
(``kernels/csrc/flash_attention.cu``); CPU tensors run
:func:`~repro_torch.kernels.flash_attention.ref.attention_ref`.  ``scale``
defaults to ``1 / sqrt(D)``.

The kernel has three instantiations; :func:`plan_attention` picks one
from the dtype and the shape alone (pure Python, so the CPU tests reach
it):

* ``"wgmma"``: bf16, ``S > SHORT_SEQ_MAX`` -- TMA loads and ``wgmma``
  tensor-core products, a 128-row query tile (64 at D > 128);
* ``"mma16"``: bf16, ``S <= SHORT_SEQ_MAX`` -- a block per (b, KV head)
  holding all of that head's K and V, ``mma.sync`` on 16-row query tiles;
* ``"simt"``: float32 -- CUDA-core products, which hold the reference's
  ``2e-5`` (tensor cores would round float32 to TF32);
* ``"wide"``: D above :data:`MAX_HEAD_DIM`, float32 or bf16 -- CUDA-core
  products with the output's columns split across blocks, 256 to a block,
  each block forming the scores from all of D in 128-column slices.

The reference's ``impl`` (Pallas or XLA), ``block_q`` / ``block_k`` (VMEM
tile sizes) and ``interpret`` are controls of its TPU lowering and have no
counterpart.  The reference pads D to 128 lanes for its MXU; here the
bf16 instantiations need D a multiple of 16 and 16-byte aligned bases and
(b, h, s) strides (TMA, ``cp.async``), so :func:`attention` pads D with
zeros (which add nothing) or makes a tensor contiguous where that does not
hold; float32 takes any D as it is, and so does ``"wide"`` in bf16.

The kernel takes per-(b, h, s) element strides with D contiguous, so a
model passes its (B, S, H, hd) activations as ``transpose(1, 2)`` views
without a copy (at hd = 64, 96, 128 or 256 in bf16 too); the output is
allocated with ``q``'s strides, so its ``transpose(1, 2)`` is contiguous
again.

Tolerances (``tests/test_torch_attention.py``, ``chip_smoke.py``): the
reference's own, ``atol = rtol = 2e-5`` in float32 and ``3e-2`` in
bfloat16 (``tests/test_kernels.py``).  The bf16 instantiations round the
weights p to bf16 for the PV product, as the reference model's
``gqa_attention`` does (the reference's Pallas kernel keeps them float32).

No gradient: the reference's kernel has no VJP, so ``attention`` raises
when autograd would record it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import count_launch, note_dispatch, use_cuda_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = [
    "attention",
    "launch_flash_attention",
    "plan_attention",
    "AttentionPlan",
    "MAX_HEAD_DIM",
    "SHORT_SEQ_MAX",
]

# the largest head dim of the tiled instantiations: "simt" keeps a 32 x 256
# output tile in registers, the bf16 ones a 64 x 256 wgmma accumulator;
# above it "wide" splits the output's columns across blocks
MAX_HEAD_DIM = 256
# bf16 sequences up to this length take "mma16" (the block stages a whole
# KV head in shared memory); longer ones "wgmma"
SHORT_SEQ_MAX = 128
# "wide": query rows and output columns of a block
WIDE_ROWS, WIDE_COLS = 32, 256
_VARIANT_CODE = {"simt": 0, "wgmma": 1, "mma16": 2, "wide": 3}
_DTYPES = (torch.float32, torch.bfloat16)

_argtypes_set = False


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class AttentionPlan:
    """How one call runs: the instantiation, the head-dim tile it is built
    for, the head dim it sees (D, or D padded with zeros to a multiple of
    16), which of q, k, v need a copy (padded or contiguous), the grid and
    the threads of a block."""

    variant: str
    tile_d: int
    head_dim: int
    copy: Tuple[bool, bool, bool]
    grid: Tuple[int, int]
    threads: int


def _tma_ready(x: torch.Tensor) -> bool:
    """D contiguous, a 16-byte base and 16-byte (b, h, s) strides (a
    dimension of size 1 has no stride to speak of)."""
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(x.stride(i) % 8 == 0 for i in range(3) if x.shape[i] > 1))


def plan_attention(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> AttentionPlan:
    """The plan for ``attention(q, k, v)`` on the card; reads only shapes,
    strides, dtypes and base addresses."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    if D > MAX_HEAD_DIM:
        return AttentionPlan(
            "wide", WIDE_COLS, D, tuple(x.stride(-1) != 1 for x in (q, k, v)),
            (B * H * _cdiv(D, WIDE_COLS), _cdiv(S, WIDE_ROWS)), 128)
    if q.dtype == torch.float32:
        tile = _cdiv(D, 32) * 32
        bq = 64 if tile <= 128 else 32
        return AttentionPlan(
            "simt", tile, D, tuple(x.stride(-1) != 1 for x in (q, k, v)),
            (B * H, _cdiv(S, bq)), 128)
    head_dim = _cdiv(D, 16) * 16
    tile = 64 if head_dim <= 64 else 128 if head_dim <= 128 else 256
    copy = tuple(head_dim != D or not _tma_ready(x) for x in (q, k, v))
    if S <= SHORT_SEQ_MAX:
        items = H // Hkv * _cdiv(S, 16)
        return AttentionPlan("mma16", tile, head_dim, copy, (B * Hkv, 1),
                             32 * min(8, items))
    return AttentionPlan("wgmma", tile, head_dim, copy,
                         (B * H, _cdiv(S, 128 if tile <= 128 else 64)),
                         384 if tile <= 128 else 256)


def _strides(x: torch.Tensor):
    """(b, h, s) element strides; a dimension of size 1 gets its
    contiguous stride (its index is always 0)."""
    shape = x.shape
    dense = (shape[1] * shape[2] * shape[3], shape[2] * shape[3], shape[3])
    return [x.stride(i) if shape[i] > 1 else dense[i] for i in range(3)]


def launch_flash_attention(
    q: torch.Tensor,   # (B, H, S, D), D contiguous
    k: torch.Tensor,   # (B, Hkv, S, D), D contiguous
    v: torch.Tensor,
    o: torch.Tensor,   # (B, H, S, D) out, D contiguous
    *,
    causal: bool,
    window: Optional[int],
    scale: float,
    plan: Optional[AttentionPlan] = None,
) -> None:
    """Launch the CUDA kernel (``plan``, default :func:`plan_attention`'s):
    ``o`` is written on the current stream; raises if the plan needs a
    copy of q, k or v (:func:`attention` makes it) or the launch fails."""
    global _argtypes_set
    from repro_torch.kernels.build import library

    plan = plan or plan_attention(q, k, v)
    if any(plan.copy) or q.shape[-1] != plan.head_dim:
        raise ValueError(
            f"launch_flash_attention: the {plan.variant} instantiation needs "
            f"q, k, v with D = {plan.head_dim} and aligned strides "
            f"(copies {plan.copy}); attention() makes them"
        )
    fn = library("flash_attention").flash_attention_launch
    if not _argtypes_set:
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
            + [ctypes.c_longlong] * 12
            + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 4
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _argtypes_set = True
    B, H, S, D = q.shape
    strides = [s for x in (q, k, v, o) for s in _strides(x)]
    dev = q.device
    # "wide" has a float32 (3) and a bf16 (4) build
    code = _VARIANT_CODE[plan.variant] + (
        plan.variant == "wide" and q.dtype == torch.bfloat16)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        code, plan.tile_d, B, H, k.shape[1], S, D,
        *strides, int(causal), int(window is not None),
        # a window beyond ±(S + 1) masks as ±(S + 1) does; kept in an int
        0 if window is None else max(-(S + 1), min(int(window), S + 1)),
        float(scale), plan.grid[0], plan.grid[1], plan.threads, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    count_launch("flash_attention", variant=plan.variant)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed ({plan}): CUDA error {err}"
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
    plan = plan_attention(q, k, v)
    pad = plan.head_dim - D
    if any(plan.copy):
        q, k, v = (
            (F.pad(x, (0, pad)) if pad else x.contiguous()) if c else x
            for x, c in zip((q, k, v), plan.copy)
        )
        plan = dataclasses.replace(plan, copy=(False, False, False))
    # q's strides when q is dense (a transposed view stays one), else
    # contiguous: D contiguous either way
    o = torch.empty_like(q)
    if o.numel():
        launch_flash_attention(q, k, v, o, causal=causal, window=window,
                               scale=scale, plan=plan)
    return o[..., :D] if pad else o
