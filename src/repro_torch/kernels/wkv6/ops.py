"""Dispatcher for the WKV6 scan (kernel B7).

``wkv6(r, k, v, lw, u, s0=None)`` -> (y (B, H, T, D) in ``r``'s dtype,
final state (B, H, D, D) float32).  CUDA tensors launch the hand-written
kernel (``kernels/csrc/wkv6.cu``); CPU tensors run :func:`wkv6_chunked`,
the plain twin of the reference's ``_wkv6_xla_chunked``: the same chunk-16
factorization, its scan over chunks a Python loop, T padded to a chunk
multiple with identity rows (r = k = v = 0, lw = 0), which leave y and the
carried state untouched.  The reference's ``impl`` switch (Pallas or XLA,
two lowerings of one function on the TPU) has no counterpart: where the
tensors live decides.

The kernel has three instantiations; :func:`plan_wkv6` picks one from
the shapes alone (pure Python, so the CPU tests reach it):

* ``"chunk"``: D <= 256, T >= 16 -- chunks of 16 rows, the value columns
  split across blocks, the chunk products on the tensor cores in 3xTF32;
* ``"step"``: D <= 256, T < 16 (a decode step) -- the recurrence, one
  pass over the state per step;
* ``"wide"``: D > 256, any T -- the recurrence with the state in device
  memory, 32 value columns a block; off every model's path.

All read r, k, v, lw through their (b, h, t) strides with D contiguous
and write y with ``r``'s strides, so a model hands over its (B, T, H, D)
projections as ``transpose(1, 2)`` views and takes y back the same way,
with no copy.  :func:`wkv6` copies an input only where the kernel cannot
take it: another dtype than float32, D not contiguous, or (``"chunk"``,
whose ``cp.async`` moves 16 bytes) a base or stride that is not 16-byte
aligned.  ``"chunk"`` and ``"step"`` are built at head dims 16, 32, 64,
128 and 256; any other D up to 256 is zero-padded to the next one (padded
channels carry r = k = v = 0 and lw = 0, which add nothing to y or S).
``"wide"`` takes any D as it is.

Tolerances (``tests/test_torch_rwkv6.py``): :func:`wkv6_chunked` and the
recurrence :func:`~repro_torch.kernels.wkv6.ref.wkv6_ref` are held to the
reference's recurrence at ``atol = rtol = 5e-4``, the reference's own
(``tests/test_kernels.py``); :func:`wkv6_chunked` is held to the
reference's ``impl="xla"`` at ``atol = rtol = 2e-5`` (the same arithmetic,
the matrix products summed in another order).  The kernel is held to
:func:`wkv6_chunked` at ``1e-4`` (``tests/test_torch_kernels_cuda.py``).

No gradient: the kernel's backward comes with the training slice, so
``wkv6`` raises when autograd would record it.
"""

from __future__ import annotations

import ctypes
import struct
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import count_launch, note_dispatch, use_cuda_kernel
from repro_torch.kernels.wkv6.ref import LOG_W_MIN

__all__ = [
    "wkv6", "wkv6_chunked", "launch_wkv6", "plan_wkv6", "kernel_inputs",
    "WKV6Plan", "CHUNK",
    "KERNEL_HEAD_DIMS", "MAX_HEAD_DIM",
]

CHUNK = 16
# head dims the tiled instantiations ("chunk", "step") are built for;
# others up to MAX_HEAD_DIM are zero-padded up to one, wider ones run "wide"
KERNEL_HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_HEAD_DIM = KERNEL_HEAD_DIMS[-1]
_VARIANT_CODE = {"chunk": 0, "step": 1, "wide": 2}
# the (b, h, t, d) strides of r, k, v, lw and y, as the launcher reads them
_pack_strides = struct.Struct("20q").pack

_launch_fn = None  # the library's wkv6_launch, bound at first launch


def wkv6_chunked(
    r: torch.Tensor,    # (B, H, T, D)
    k: torch.Tensor,
    v: torch.Tensor,
    lw: torch.Tensor,   # (B, H, T, D) log decay (clamped here)
    u: torch.Tensor,    # (H, D)
    s0: Optional[torch.Tensor] = None,  # (B, H, D, D)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked plain version: the kernel's factorization in float32
    tensor ops, one loop step per chunk for the carried state."""
    B, H, T, D = r.shape
    f32 = torch.float32
    pad = (-T) % CHUNK
    rf, kf, vf, lwf = (
        F.pad(x.to(f32), (0, 0, 0, pad)) for x in (r, k, v, lw)
    )
    nc = (T + pad) // CHUNK
    rc, kc, vc = (x.reshape(B, H, nc, CHUNK, D) for x in (rf, kf, vf))
    lwc = torch.clamp(lwf, LOG_W_MIN, 0.0).reshape(B, H, nc, CHUNK, D)

    cum = torch.cumsum(lwc, dim=3)
    cum_prev = cum - lwc
    r_t = rc * torch.exp(cum_prev)
    k_t = kc * torch.exp(-cum)
    A = torch.einsum("bhcti,bhcai->bhcta", r_t, k_t)
    pos = torch.arange(CHUNK, device=r.device)
    A = torch.where(pos[None, :] < pos[:, None], A, 0.0)  # strict lower
    y_intra = torch.einsum("bhcta,bhcad->bhctd", A, vc)
    diag_coef = torch.sum(rc * u.to(f32)[None, :, None, None, :] * kc, dim=-1)
    y_local = y_intra + diag_coef[..., None] * vc

    decay_last = torch.exp(cum[:, :, :, -1])              # (B, H, nc, D)
    kv = torch.einsum("bhcai,bhcad->bhcid", k_t, vc)      # (B, H, nc, D, D)

    S = (torch.zeros((B, H, D, D), dtype=f32, device=r.device)
         if s0 is None else s0.to(f32))
    ys = []
    for c in range(nc):
        ys.append(torch.einsum("bhti,bhid->bhtd", r_t[:, :, c], S)
                  + y_local[:, :, c])
        S = decay_last[:, :, c, :, None] * (S + kv[:, :, c])
    y = (torch.stack(ys, dim=2).reshape(B, H, nc * CHUNK, D) if ys
         else rf.new_zeros((B, H, 0, D)))
    return y[:, :, :T].to(r.dtype), S


class WKV6Plan(NamedTuple):
    """How one call runs on the card: the instantiation, the head dim it
    is built for (D, or D zero-padded up to it), and which of r, k, v, lw
    are copied (converted to float32, padded or made contiguous)."""

    variant: str
    head_dim: int
    copy: Tuple[bool, bool, bool, bool]


def _variant(T: int, D: int) -> str:
    """The instantiation for T rows of head dim D: the recurrence below
    one chunk, and above the tiled head dims."""
    if D > MAX_HEAD_DIM:
        return "wide"
    return "step" if T < CHUNK else "chunk"


def _strides(x: torch.Tensor):
    """(b, h, t) element strides; a dimension of size 1 gets its
    contiguous stride (its index is always 0)."""
    B, H, T, D = x.shape
    sb, sh, st, _ = x.stride()
    return (sb if B > 1 else H * T * D, sh if H > 1 else T * D,
            st if T > 1 else D)


def _takes(x: torch.Tensor, floats: int) -> bool:
    """float32, D contiguous, base and (b, h, t) strides a multiple of
    ``floats`` elements."""
    if x.dtype != torch.float32 or x.stride(3) != 1:
        return False
    if floats == 1:
        return True
    return (x.data_ptr() % (4 * floats) == 0
            and not any(s % floats for s in _strides(x)))


def plan_wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              lw: torch.Tensor) -> WKV6Plan:
    """The plan for ``wkv6(r, k, v, lw, ...)`` on the card; reads only
    shapes, strides, dtypes and base addresses."""
    T, D = r.shape[2], r.shape[3]
    variant = _variant(T, D)
    head_dim = D if D in KERNEL_HEAD_DIMS or variant == "wide" else next(
        d for d in KERNEL_HEAD_DIMS if d >= D)
    floats = 4 if variant == "chunk" else 1
    return WKV6Plan(variant, head_dim, tuple(
        head_dim != D or not _takes(x, floats) for x in (r, k, v, lw)))


def launch_wkv6(
    r: torch.Tensor,    # (B, H, T, D) float32, D contiguous (as k, v, lw)
    k: torch.Tensor,
    v: torch.Tensor,
    lw: torch.Tensor,
    u: torch.Tensor,    # (H, D) float32, contiguous
    s0: Optional[torch.Tensor],  # (B, H, D, D) float32, contiguous, or None
    y: torch.Tensor,    # (B, H, T, D) float32 out, D contiguous
    s_out: torch.Tensor,  # (B, H, D, D) float32 out, contiguous
) -> None:
    """Launch the CUDA kernel (``"wide"`` for D > 256, else ``"step"``
    for T < 16 and ``"chunk"`` above): ``y`` and ``s_out`` are written on
    the current stream; raises if the launch fails (a D the tiled kernels
    are not built for, strides the instantiation cannot take)."""
    global _launch_fn
    if _launch_fn is None:
        from repro_torch.kernels.build import library

        fn = library("wkv6").wkv6_launch
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                       + [ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launch_fn = fn
    B, H, T, D = r.shape
    variant = _variant(T, D)
    index = r.get_device()
    # a decode launch takes less device time than its host work: the raw
    # stream handle costs a tenth of torch.cuda.current_stream(...)
    err = _launch_fn(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
        u.data_ptr(), 0 if s0 is None else s0.data_ptr(),
        y.data_ptr(), s_out.data_ptr(), B, H, T, D, _VARIANT_CODE[variant],
        _pack_strides(*r.stride(), *k.stride(), *v.stride(), *lw.stride(),
                      *y.stride()),
        index, torch._C._cuda_getCurrentRawStream(index),
    )
    count_launch("wkv6", variant=variant)
    if err != 0:
        raise RuntimeError(
            f"wkv6 kernel launch failed ({variant}, D = {D}): CUDA error {err}"
        )


def wkv6(
    r: torch.Tensor,    # (B, H, T, D)
    k: torch.Tensor,
    v: torch.Tensor,
    lw: torch.Tensor,   # (B, H, T, D) log decay (clamped internally)
    u: torch.Tensor,    # (H, D)
    s0: Optional[torch.Tensor] = None,  # (B, H, D, D)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, H, T, D) in ``r``'s dtype, final state (B, H, D, D) float32).
    On the card y has ``r``'s strides where ``r`` goes in uncopied."""
    if r.dim() != 4 or any(x.shape != r.shape for x in (k, v, lw)):
        raise ValueError(
            f"wkv6: r, k, v, lw must share one (B, H, T, D) shape, got "
            f"{[tuple(x.shape) for x in (r, k, v, lw)]}"
        )
    B, H, T, D = r.shape
    if u.shape != (H, D):
        raise ValueError(f"wkv6: u must be ({H}, {D}), got {tuple(u.shape)}")
    if s0 is not None and s0.shape != (B, H, D, D):
        raise ValueError(
            f"wkv6: s0 must be ({B}, {H}, {D}, {D}), got {tuple(s0.shape)}"
        )
    given = [x for x in (r, k, v, lw, u, s0) if x is not None]
    if torch.is_grad_enabled() and any(x.requires_grad for x in given):
        raise NotImplementedError(
            "wkv6: no backward yet (it comes with the training slice, "
            "ROADMAP); call under torch.inference_mode() or torch.no_grad()"
        )
    if not use_cuda_kernel("wkv6", *given):
        note_dispatch("wkv6", "ref")
        return wkv6_chunked(r, k, v, lw, u, s0)
    note_dispatch("wkv6", "cuda")
    plan = plan_wkv6(r, k, v, lw)
    *ins, u_in, s0_in = kernel_inputs(plan, r, k, v, lw, u, s0)
    # r's strides when r goes in as it is (a transposed view stays one)
    y = torch.empty_like(ins[0])
    s_out = y.new_empty((B, H, plan.head_dim, plan.head_dim))
    launch_wkv6(*ins, u_in, s0_in, y, s_out)
    if plan.head_dim != D:
        y, s_out = y[..., :D], s_out[..., :D, :D].contiguous()
    return (y if r.dtype == torch.float32 else y.to(r.dtype)), s_out


def kernel_inputs(plan: WKV6Plan, r, k, v, lw, u, s0=None):
    """(r, k, v, lw, u, s0) as ``plan`` launches them: the inputs it marks
    copied as contiguous float32, zero-padded to ``plan.head_dim``; u and
    s0 contiguous float32 on a 16-byte base (the state moves as float4),
    padded likewise; the others as they are."""
    pad = plan.head_dim - r.shape[-1]

    def padded(x, dims):
        if pad:  # a new tensor, contiguous on a fresh base
            return F.pad(x.to(torch.float32), (0, pad) * dims)
        if (x.dtype == torch.float32 and x.is_contiguous()
                and x.data_ptr() % 16 == 0):
            return x
        return x.to(torch.float32, memory_format=torch.contiguous_format,
                    copy=True)

    ins = [padded(x, 1) if c else x
           for x, c in zip((r, k, v, lw), plan.copy)]
    return (*ins, padded(u, 1), None if s0 is None else padded(s0, 2))
