"""Dispatcher for flash attention (kernel B6).

``attention(q, k, v, *, causal=True, window=None, scale=None)`` -> (B, H,
S, D) in ``q``'s dtype, for q (B, H, S, D) and k, v (B, Hkv, S, D) with
``H`` a multiple of ``Hkv``.  CUDA tensors launch the hand-written kernel
(``kernels/csrc/flash_attention.cu``); CPU tensors run
:func:`~repro_torch.kernels.flash_attention.ref.attention_ref`.  ``scale``
defaults to ``1 / sqrt(D)``.

The kernel has four instantiations; :func:`plan_attention` picks one
from the dtype and the shape alone (pure Python, so the CPU tests reach
it):

* ``"wgmma"``: bf16, ``S > SHORT_SEQ_MAX`` -- TMA loads and ``wgmma``
  tensor-core products, a 128-row query tile (64 at D > 128);
* ``"mma16"``: bf16, ``S <= SHORT_SEQ_MAX`` -- a block per (b, KV head)
  holding all of that head's K and V, ``mma.sync`` on 16-row query tiles;
* ``"f32"``: float32 -- every product a 3xTF32 ``mma.sync`` on the tensor
  cores (three TF32 products of split operands, ~2^-21 relative, which
  hold the reference's ``2e-5`` where one TF32 product would not): a warp
  per 16 query rows, 128 rows a block up to D = 128 and 64 above (two
  warps splitting D), 32 for sequences up to :data:`F32_SHORT_S` at D <=
  64; K and V tiles by ``cp.async``;
* ``"wide"``: D above :data:`MAX_HEAD_DIM` -- in bf16 the tensor cores
  (TMA + ``wgmma``): a 64-row query tile whose two consumer warpgroups
  split D for the scores, summed once through shared memory, and 512
  output columns for P V (wider heads take column passes); in float32
  CUDA-core products, a 32-row query tile and up to 1,024 output columns
  a block, each score formed once up to that width.

The reference's ``impl`` (Pallas or XLA), ``block_q`` / ``block_k`` (VMEM
tile sizes) and ``interpret`` are controls of its TPU lowering and have no
counterpart.  The reference pads D to 128 lanes for its MXU; here the
bf16 instantiations need D a multiple of 16 and 16-byte aligned bases and
(b, h, s) strides (TMA, ``cp.async``), ``"f32"`` D a multiple of 4 with
the same alignment (``cp.async``), so :func:`attention` pads D with zeros
(which add nothing) or copies a tensor where that does not hold
(``"wide"`` in bf16: D a multiple of 8, TMA zero-fills the rest of its
64-column boxes); ``"wide"`` in float32 takes any D as it is.

The kernel takes per-(b, h, s) element strides with D contiguous, so a
model passes its (B, S, H, hd) activations as ``transpose(1, 2)`` views
without a copy (at hd = 64, 96, 128 or 256 in both dtypes); the output is
allocated with ``q``'s strides, so its ``transpose(1, 2)`` is contiguous
again.

Tolerances (``tests/test_torch_attention.py``, ``chip_smoke.py``): the
reference's own, ``atol = rtol = 2e-5`` in float32 and ``3e-2`` in
bfloat16 (``tests/test_kernels.py``), the same on every instantiation.  The bf16 instantiations round the
weights p to bf16 for the PV product, as the reference model's
``gqa_attention`` does (the reference's Pallas kernel keeps them float32).

**Gradient.**  The reference's kernel has no VJP (its models
differentiate the XLA path).  Here, on CUDA tensors that need a gradient,
``attention`` is a ``torch.autograd.Function``: its forward launches the
forward kernel exactly as above (same plan, same instantiation, same
bits of o) and also has it write each row's log-sum-exp; it saves q, k,
v, o and that lse.  Its backward calls :func:`attention_bwd`, the
hand-written backward kernel (``kernels/csrc/flash_attention_bwd.cu``):
the Δ pre-pass, a dQ kernel and a dK / dV kernel that take P = exp(scale
· s − lse) from the saved lse and give every query head its own blocks,
and, when H > Hkv, the group sum of the per-head float32 partials in head
order -- 3 or 4 launches, in one of four variants that
:func:`plan_attention_bwd` picks:

* ``"wgmma"``, bf16: TMA + ``wgmma`` tensor-core products (``delta``,
  ``dq``, ``dkdv``, ``reduce``);
* ``"f32"``, float32: every product a 3xTF32 ``mma.sync`` on the tensor
  cores (three TF32 products of split operands, ~2^-21 relative, which
  hold the 1e-4 float32 bound where one would not), tiles by
  ``cp.async`` (``f32_delta``, ``f32_dq``, ``f32_dkdv``, ``f32_reduce``);
* ``"wide"``, D above :data:`MAX_HEAD_DIM`: in bf16 the same passes with
  64 x 64 TMA boxes through one ring, the two consumer warpgroups
  splitting D for each score product and adding their partials once
  (``delta``, ``wide_dq``, ``wide_dkdv``, ``reduce``); in float32 the
  3xTF32 kernels with the scores contracted over D in chunks, four warps
  splitting each chunk and adding their partials (``f32_delta``,
  ``f32_wide_dq``, ``f32_wide_dkdv``, ``f32_reduce``).  The output
  columns go in passes: 512 of dQ, 256 of dK and dV a bf16 block, 512 a
  float32 one, each pass forming its tile's scores again.

Each launch counts in ``LAUNCHES["flash_attention_bwd"]`` and, by name, in
``VARIANT_LAUNCHES["flash_attention_bwd"]``; no launch uses atomics, so
two runs give the same bits.  bf16 pads D to a multiple of 16 and copies
a tensor TMA cannot take, as the forward does (``"wide"``: D padded to a
multiple of 8); float32 pads D to a multiple of 4 and copies a tensor
whose base or (b, h, s) strides are not 16-byte aligned.
Under ``no_grad`` / ``inference_mode`` nothing
changes and no lse is written.  CPU tensors run ``attention_ref``, which
autograd differentiates; :func:`attention_with_lse` and
:func:`attention_bwd` run ``attention_lse_ref`` / ``attention_bwd_ref``.
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
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref,
    attention_lse_ref,
    attention_ref,
)

__all__ = [
    "attention",
    "attention_with_lse",
    "attention_bwd",
    "launch_flash_attention",
    "launch_flash_attention_bwd",
    "plan_attention",
    "plan_attention_bwd",
    "AttentionPlan",
    "AttentionBwdPlan",
    "MAX_HEAD_DIM",
    "SHORT_SEQ_MAX",
    "F32_SHORT_S",
]

# the largest head dim of the tiled instantiations: "f32" keeps a 16 x 128
# output tile a warp in registers (two warps share 16 rows above D = 128),
# the bf16 ones a 64 x 256 wgmma accumulator; above it "wide" splits the
# output's columns across warpgroups or threads
MAX_HEAD_DIM = 256
# bf16 sequences up to this length take "mma16" (the block stages a whole
# KV head in shared memory); longer ones "wgmma"
SHORT_SEQ_MAX = 128
# float32 at head-dim tiles up to 64: sequences up to this length take
# 32-row tiles, in the forward ("f32") and the backward (F32Cfg,
# flash_attention_bwd.cu) alike
F32_SHORT_S = 96
_VARIANT_CODE = {"f32": 0, "wgmma": 1, "mma16": 2, "wide": 3}
_DTYPES = (torch.float32, torch.bfloat16)

_argtypes_set = False
_bwd_fns = {}


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
    st, shape = x.stride(), x.shape
    return (st[3] == 1 and x.data_ptr() % 16 == 0
            and (st[0] % 8 == 0 or shape[0] == 1)
            and (st[1] % 8 == 0 or shape[1] == 1)
            and (st[2] % 8 == 0 or shape[2] == 1))


def _f32_ready(x: torch.Tensor) -> bool:
    """D contiguous, a 16-byte base and (b, h, s) strides of whole 16-byte
    groups of float32 (``cp.async``)."""
    st, shape = x.stride(), x.shape
    return (st[3] == 1 and x.data_ptr() % 16 == 0
            and all(st[i] % 4 == 0 or shape[i] == 1 for i in range(3)))


def plan_attention(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> AttentionPlan:
    """The plan for ``attention(q, k, v)`` on the card; reads only shapes,
    strides, dtypes and base addresses."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    if D > MAX_HEAD_DIM:
        # "wide": a block's query rows and output columns (more columns
        # take column passes); bf16 needs 16-byte rows for TMA
        if q.dtype == torch.bfloat16:
            head_dim = _cdiv(D, 8) * 8
            copy = tuple(head_dim != D or not _tma_ready(x) for x in (q, k, v))
            rows, cols, threads = 64, 512, 384
        else:
            head_dim, copy = D, tuple(x.stride(-1) != 1 for x in (q, k, v))
            rows, cols, threads = 32, 512 if D <= 512 else 1024, 256
        return AttentionPlan("wide", cols, head_dim, copy,
                             (B * H * _cdiv(head_dim, cols), _cdiv(S, rows)),
                             threads)
    if q.dtype == torch.float32:
        # D padded to a multiple of 4; query rows a block (32 for short
        # sequences) and threads as flash_attention.cu's F32FwdCfg
        head_dim = _cdiv(D, 4) * 4
        tile = _cdiv(head_dim, 32) * 32
        short = tile <= 64 and S <= F32_SHORT_S
        rows = 32 if short else 128 if tile <= 128 else 64
        return AttentionPlan(
            "f32", tile, head_dim,
            tuple(head_dim != D or not _f32_ready(x) for x in (q, k, v)),
            (B * H, _cdiv(S, rows)), 64 if short else 256)
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
    (_, h, s, d), st = x.shape, x.stride()
    return (st[0] if x.shape[0] > 1 else h * s * d,
            st[1] if h > 1 else s * d, st[2] if s > 1 else d)


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
    lse: Optional[torch.Tensor] = None,  # (B, H, S) float32 out, or None
) -> None:
    """Launch the CUDA kernel (``plan``, default :func:`plan_attention`'s):
    ``o`` is written on the current stream, and ``lse`` (each row's
    log-sum-exp) when given; raises if the plan needs a copy of q, k or v
    (:func:`attention` makes it) or the launch fails."""
    global _argtypes_set
    from repro_torch.kernels.build import library

    plan = plan or plan_attention(q, k, v)
    if any(plan.copy) or q.shape[-1] != plan.head_dim:
        raise ValueError(
            f"launch_flash_attention: the {plan.variant} instantiation needs "
            f"q, k, v with D = {plan.head_dim} and aligned strides "
            f"(copies {plan.copy}); attention() makes them"
        )
    if lse is not None and (
            lse.dtype != torch.float32 or lse.shape != q.shape[:3]
            or not lse.is_contiguous()):
        raise ValueError(
            f"launch_flash_attention: lse must be a contiguous float32 "
            f"{tuple(q.shape[:3])} tensor, got "
            f"{(lse.dtype, tuple(lse.shape))}"
        )
    fn = library("flash_attention").flash_attention_launch
    if not _argtypes_set:
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
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
        None if lse is None else lse.data_ptr(),
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


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
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


def _check_dtypes(*xs: torch.Tensor) -> None:
    if xs[0].dtype not in _DTYPES or any(x.dtype != xs[0].dtype for x in xs):
        raise TypeError(
            f"attention: the kernel takes float32 or bfloat16 q, k, v of one "
            f"dtype, got {[x.dtype for x in xs]}"
        )


def _forward_cuda(q, k, v, causal, window, scale, with_lse=False):
    """The forward kernel on CUDA tensors: the plan, the copies it asks
    for, the launch, the padded head dim sliced off.  Returns o, or
    (o, lse) with ``with_lse`` (o has the same bits either way)."""
    D = q.shape[-1]
    plan = plan_attention(q, k, v)
    pad = plan.head_dim - D
    if any(plan.copy):
        # a fresh allocation: a contiguous tensor may sit at an unaligned base
        q, k, v = (
            (F.pad(x, (0, pad)) if pad
             else x.clone(memory_format=torch.contiguous_format)) if c else x
            for x, c in zip((q, k, v), plan.copy)
        )
        plan = dataclasses.replace(plan, copy=(False, False, False))
    # q's strides when q is dense (a transposed view stays one), else
    # contiguous: D contiguous either way
    o = torch.empty_like(q)
    lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
           if with_lse else None)
    if o.numel():
        launch_flash_attention(q, k, v, o, causal=causal, window=window,
                               scale=scale, plan=plan, lse=lse)
    o = o[..., :D] if pad else o
    return (o, lse) if with_lse else o


class _Attention(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        # the backward reads P = exp(scale * s - lse) from the saved lse
        o, lse = _forward_cuda(q, k, v, causal, window, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, window, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, scale = ctx.args
        dq, dk, dv = attention_bwd(q, k, v, o, do, causal=causal,
                                   window=window, scale=scale, lse=lse)
        return dq, dk, dv, None, None, None


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
    dtype; differentiable (see the module's note on the gradient)."""
    _check_shapes(q, k, v)
    D = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if not use_cuda_kernel("flash_attention", q, k, v):
        note_dispatch("flash_attention", "ref")
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale)
    note_dispatch("flash_attention", "cuda")
    _check_dtypes(q, k, v)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _Attention.apply(q, k, v, causal, window, scale)
    return _forward_cuda(q, k, v, causal, window, scale)


def attention_with_lse(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,  # (B, Hkv, S, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): :func:`attention`'s output (no autograd) and each row's
    log-sum-exp of its visible scaled scores, (B, H, S) float32, +inf for a
    row that sees no key -- what the forward saves for the backward.  CUDA
    tensors: the forward kernel (either dtype, any D); CPU tensors:
    :func:`attention_lse_ref`."""
    _check_shapes(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not use_cuda_kernel("flash_attention", q, k, v):
        note_dispatch("flash_attention", "ref")
        return attention_lse_ref(q, k, v, causal=causal, window=window,
                                 scale=scale)
    note_dispatch("flash_attention", "cuda")
    _check_dtypes(q, k, v)
    with torch.no_grad():
        return _forward_cuda(q, k, v, causal, window, scale, with_lse=True)


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AttentionBwdPlan:
    """How one backward call runs: the variant (``"wgmma"`` for bf16,
    ``"f32"`` for float32, ``"wide"`` above :data:`MAX_HEAD_DIM`), the
    head-dim tile the kernels are built for (``"wide"``: dQ's output
    columns a block, 512), the head dim they see (D padded with zeros to a
    multiple of 16 in bf16, 8 in bf16 ``"wide"``, 4 in float32), the rows
    of a block's query tile in the dQ kernel and of its key tile in the
    dK / dV kernel, which of q, k, v, o, dO need a copy (padded or made
    contiguous), whether the group sum launches (H > Hkv), the float32
    scratch the call allocates in bytes (Δ, and with the group sum the
    per-head partial dK, dV), and its launches by name."""

    variant: str
    tile_d: int
    head_dim: int
    rows: Tuple[int, int]
    copy: Tuple[bool, bool, bool, bool, bool]
    reduce: bool
    scratch_bytes: int
    launches: Tuple[str, ...]


# float32 tiled: the head-dim tile -> (query rows of a dQ block, key rows
# of a dK / dV block); at D <= 64 sequences up to F32_SHORT_S rows take
# 32-row tiles (flash_attention_bwd.cu, F32Cfg)
_F32_ROWS = {32: (64, 64), 64: (64, 64), 128: (128, 128), 256: (64, 32)}


def plan_attention_bwd(q, k, v, o, do) -> AttentionBwdPlan:
    """The plan for ``attention_bwd`` on the card; reads only shapes,
    strides, dtypes and base addresses."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    xs = (q, k, v, o, do)
    reduce = H > Hkv
    group_sum = ("reduce",) if reduce else ()
    if q.dtype == torch.float32:
        head_dim = _cdiv(D, 4) * 4
        copy = tuple(head_dim != D or not _f32_ready(x) for x in xs)
        # each kernel's Δ, and the per-head partials of the group sum
        scratch = 4 * B * H * S * (2 + (2 * head_dim if reduce else 0))
        if D > MAX_HEAD_DIM:
            variant, tile, rows = "wide", 512, (32, 32)
        else:
            variant = "f32"
            tile = next(t for t in (32, 64, 128, 256) if head_dim <= t)
            rows = ((32, 32) if tile <= 64 and S <= F32_SHORT_S
                    else _F32_ROWS[tile])
        kernels = ("wide_dq", "wide_dkdv") if variant == "wide" else (
            "dq", "dkdv")
        return AttentionBwdPlan(
            variant, tile, head_dim, rows, copy, reduce, scratch,
            tuple(f"f32_{n}" for n in ("delta",) + kernels + group_sum))
    # Δ, and with grouped heads the float32 partial dK, dV of every head
    if D > MAX_HEAD_DIM:
        head_dim = _cdiv(D, 8) * 8
        tile, rows, variant, kernels = 512, 64, "wide", ("wide_dq",
                                                         "wide_dkdv")
    else:
        head_dim = _cdiv(D, 16) * 16
        tile = 64 if head_dim <= 64 else 128 if head_dim <= 128 else 256
        rows, variant, kernels = (128 if tile <= 128 else 64), "wgmma", (
            "dq", "dkdv")
    return AttentionBwdPlan(
        variant, tile, head_dim, (rows, rows),
        tuple(head_dim != D or not _tma_ready(x) for x in xs), reduce,
        4 * B * H * S * (1 + (2 * head_dim if reduce else 0)),
        ("delta",) + kernels + group_sum)


def _bwd_fn(dtype: torch.dtype):
    """The backward library's C entry point for ``dtype``, typed."""
    fn = _bwd_fns.get(dtype)
    if fn is None:
        from repro_torch.kernels.build import library

        lib = library("flash_attention_bwd")
        fn = (lib.flash_attention_bwd_f32_launch if dtype == torch.float32
              else lib.flash_attention_bwd_wgmma_launch)
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p] + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bwd_fns[dtype] = fn
    return fn


def launch_flash_attention_bwd(
    q, k, v, o, do, dq, dk, dv, *, causal: bool, window: Optional[int],
    scale: float, lse: Optional[torch.Tensor] = None,
    plan: Optional[AttentionBwdPlan] = None,
) -> None:
    """Launch the backward kernels of ``plan`` (default
    :func:`plan_attention_bwd`'s) on the current stream: ``dq``, ``dk``,
    ``dv`` written.  Every tensor as the plan needs it (:func:`attention_bwd`
    pads or copies); the kernels read the forward's ``lse`` (B, H, S)
    float32.  Scratch is allocated here."""
    plan = plan or plan_attention_bwd(q, k, v, o, do)
    if (any(plan.copy) or q.shape[-1] != plan.head_dim
            or any(x.stride(-1) != 1 for x in (dq, dk, dv))):
        raise ValueError(
            f"launch_flash_attention_bwd: the {plan.variant} variant needs "
            f"D = {plan.head_dim}, D contiguous and 16-byte strides "
            f"(copies {plan.copy}); attention_bwd() makes them"
        )
    if (lse is None or lse.dtype != torch.float32
            or lse.shape != q.shape[:3] or not lse.is_contiguous()):
        raise ValueError(
            f"launch_flash_attention_bwd: {plan.variant} needs the "
            f"forward's lse, a contiguous float32 {tuple(q.shape[:3])} "
            f"tensor (attention_with_lse)"
        )
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    strides = (ctypes.c_longlong * 24)(
        *(s for x in (q, k, v, o, do, dq, dk, dv) for s in _strides(x)))
    win = 0 if window is None else max(-(S + 1), min(int(window), S + 1))
    dev = q.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [x.data_ptr() for x in (q, k, v, o, do)]
    outs = [x.data_ptr() for x in (dq, dk, dv)]
    # Δ: the float32 kernels each form their own (two planes)
    delta = torch.empty((1 + (q.dtype == torch.float32)) * B * H * S,
                        dtype=torch.float32, device=dev)
    part = (torch.empty(2 * B * H * S * D, dtype=torch.float32, device=dev)
            if plan.reduce else None)
    err = _bwd_fn(q.dtype)(
        *ptrs, lse.data_ptr(), delta.data_ptr(), *outs,
        None if part is None else part.data_ptr(), plan.tile_d, B, H, Hkv, S,
        D, ctypes.cast(strides, ctypes.c_void_p), int(causal),
        int(window is not None), win, float(scale), dev.index, stream)
    for name in plan.launches:
        count_launch("flash_attention_bwd", variant=name)
    if err != 0:
        raise RuntimeError(
            f"flash_attention_bwd kernel launch failed ({plan}): CUDA error "
            f"{err}"
        )


def attention_bwd(
    q: torch.Tensor,   # (B, H, S, D)
    k: torch.Tensor,   # (B, Hkv, S, D)
    v: torch.Tensor,
    o: torch.Tensor,   # (B, H, S, D) the forward's output
    do: torch.Tensor,  # (B, H, S, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    lse: Optional[torch.Tensor] = None,  # (B, H, S) the forward's
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`attention`, each with its input's shape and
    dtype (and strides, where the input is dense and needs no padding):
    the backward kernel on CUDA tensors, :func:`attention_bwd_ref` on CPU
    tensors.  ``lse`` is the forward's log-sum-exp
    (:func:`attention_with_lse`); a CUDA call without it launches the
    forward kernel once more to get it."""
    _check_shapes(q, k, v)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(
            f"attention_bwd: o {tuple(o.shape)} and do {tuple(do.shape)} "
            f"must have q's shape {tuple(q.shape)}"
        )
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not use_cuda_kernel("flash_attention_bwd", q, k, v, o, do):
        note_dispatch("flash_attention_bwd", "ref")
        return attention_bwd_ref(q, k, v, o, do, causal=causal,
                                 window=window, scale=scale, lse=lse)
    note_dispatch("flash_attention_bwd", "cuda")
    _check_dtypes(q, k, v, o, do)
    plan = plan_attention_bwd(q, k, v, o, do)
    if lse is None:
        _, lse = _forward_cuda(q, k, v, causal, window, scale, with_lse=True)
    D = q.shape[-1]
    pad = plan.head_dim - D
    if any(plan.copy):
        # a fresh allocation: a contiguous tensor may sit at an unaligned base
        q, k, v, o, do = (
            (F.pad(x, (0, pad)) if pad
             else x.clone(memory_format=torch.contiguous_format)) if c else x
            for x, c in zip((q, k, v, o, do), plan.copy))
        plan = dataclasses.replace(plan, copy=(False,) * 5)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if dq.numel():
        launch_flash_attention_bwd(q, k, v, o, do, dq, dk, dv, causal=causal,
                                   window=window, scale=scale, lse=lse,
                                   plan=plan)
    if pad:
        return dq[..., :D], dk[..., :D], dv[..., :D]
    return dq, dk, dv
