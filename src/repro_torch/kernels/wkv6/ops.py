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

The kernel has four instantiations; :func:`plan_wkv6` picks one from
the shapes alone (pure Python, so the CPU tests reach it):

* ``"chunk"``: D <= 256, T >= 16 -- chunks of 16 rows, the value columns
  split across blocks, the chunk products on the tensor cores in 3xTF32;
* ``"step"``: D <= 256, T < 16 (a decode step) -- the recurrence, one
  pass over the state per step;
* ``"wide_chunk"``: 256 < D <= :data:`WIDE_CHUNK_MAX`, T >= 16 -- the
  chunk factorization with 16 value columns a block and the key rows
  split across its 8 warps, the channels staged in slices of 128;
* ``"wide_step"``: D > 256 and T < 16, or D above ``WIDE_CHUNK_MAX`` --
  the recurrence with the state in device memory, 32 value columns a
  block.

The two ``wide`` ones are off every model's path.

All read r, k, v, lw through their (b, h, t) strides with D contiguous
and write y with ``r``'s strides, so a model hands over its (B, T, H, D)
projections as ``transpose(1, 2)`` views and takes y back the same way,
with no copy.  :func:`wkv6` copies an input only where the kernel cannot
take it: another dtype than float32, D not contiguous, or (``"chunk"``
and ``"wide_chunk"``, whose ``cp.async`` moves 16 bytes) a base or stride
that is not 16-byte aligned.  ``"chunk"`` and ``"step"`` are built at
head dims 16, 32, 64, 128 and 256; any other D up to 256 is zero-padded
to the next one (padded channels carry r = k = v = 0 and lw = 0, which
add nothing to y or S).
``"wide_chunk"`` pads D to a multiple of 4 here (16-byte rows for
``cp.async``) and further inside the kernel; ``"wide_step"`` takes any D
as it is.

Tolerances (``tests/test_torch_rwkv6.py``): :func:`wkv6_chunked` and the
recurrence :func:`~repro_torch.kernels.wkv6.ref.wkv6_ref` are held to the
reference's recurrence at ``atol = rtol = 5e-4``, the reference's own
(``tests/test_kernels.py``); :func:`wkv6_chunked` is held to the
reference's ``impl="xla"`` at ``atol = rtol = 2e-5`` (the same arithmetic,
the matrix products summed in another order).  The kernel is held to
:func:`wkv6_chunked` at ``1e-4`` (``tests/test_torch_kernels_cuda.py``).

Gradient: on CPU tensors autograd differentiates :func:`wkv6_chunked`.
On CUDA tensors that autograd records, ``wkv6`` is a
``torch.autograd.Function`` (:class:`_WKV6`): its forward launches the
kernel above unchanged and saves only its inputs (a checkpoint's
recomputation reproduces them), its backward launches B7's backward
kernels (``kernels/csrc/wkv6_bwd.cu``, through :func:`wkv6_bwd`: the
chunks in order for dr, dlw's q and du, then in reverse for dk, dv, dlw
and ds0, each only where a gradient it writes is asked for) for the
gradients autograd asks for.  :func:`plan_wkv6_bwd` names the variant:
``"chunk"`` at head dim 64 (every registry model's; a smaller D
zero-padded to it), two launches ``fwd`` and ``rev`` with a block per
(b, h); ``"wide"`` above it (D zero-padded to a multiple of 4), the
value columns split over blocks of 16 (a block per (b, h, column group,
channel pass of up to 2,048 channels)): ``wide_fwd`` and ``wide_rev``
write each group's partial dr, dk, dlw and du into scratch,
``wide_reduce`` adds them in group order; where the partials would pass
1 GiB the groups run in batches that fit, each batch's sum continuing the
last one's, the same bits.  The library says what a call launches and
how much scratch it takes (:func:`bwd_schedule`).  On the card nothing
falls back to a plain version.
:func:`wkv6_bwd` runs
:func:`~repro_torch.kernels.wkv6.ref.wkv6_bwd_ref` on CPU tensors, which
follows ``torch.clamp``'s rule at the clamp's ends (gradient 1 on
[LOG_W_MIN, 0], ends included; ``jnp.clip``'s is 0.5 there).  The
backward kernel is held to ``wkv6_bwd_ref`` within ``1e-4`` of each
gradient's largest |value| (+ ``1e-6``) in float32
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import ctypes
import struct
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import count_launch, note_dispatch, use_cuda_kernel
from repro_torch.kernels.wkv6.ref import LOG_W_MIN, wkv6_bwd_ref

__all__ = [
    "wkv6", "wkv6_chunked", "launch_wkv6", "plan_wkv6", "kernel_inputs",
    "WKV6Plan", "CHUNK",
    "KERNEL_HEAD_DIMS", "MAX_HEAD_DIM", "WIDE_CHUNK_MAX",
    "wkv6_bwd", "launch_wkv6_bwd", "plan_wkv6_bwd", "WKV6BwdPlan",
    "bwd_schedule", "BWD_KERNELS",
]

CHUNK = 16
# head dims the tiled instantiations ("chunk", "step") are built for;
# others up to MAX_HEAD_DIM are zero-padded up to one, wider ones run
# "wide_chunk" or "wide_step"
KERNEL_HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_HEAD_DIM = KERNEL_HEAD_DIMS[-1]
# the widest head "wide_chunk" is built for: 16 value columns of the state
# over 2,048 key rows fill its warps' registers
WIDE_CHUNK_MAX = 2048
_VARIANT_CODE = {"chunk": 0, "step": 1, "wide_step": 2, "wide_chunk": 3}
# the (b, h, t, d) strides of r, k, v, lw and y, as the launcher reads them
_pack_strides = struct.Struct("20q").pack

_launch_fn = None  # the library's wkv6_launch, bound at first launch
_bwd_lib = None    # the wkv6_bwd library, its entries bound at first use
# the backward's kernels of each variant, in the order of the library's
# wkv6_bwd_kernels counts
BWD_KERNELS = {"chunk": ("fwd", "rev"),
               "wide": ("wide_fwd", "wide_rev", "wide_reduce")}


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
        chunked = T >= CHUNK and D <= WIDE_CHUNK_MAX
        return "wide_chunk" if chunked else "wide_step"
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
    if variant == "wide_chunk":
        head_dim = -(-D // 4) * 4
    elif variant == "wide_step" or D in KERNEL_HEAD_DIMS:
        head_dim = D
    else:
        head_dim = next(d for d in KERNEL_HEAD_DIMS if d >= D)
    floats = 4 if variant in ("chunk", "wide_chunk") else 1
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
    """Launch the CUDA kernel (the instantiation :func:`plan_wkv6` names
    for these shapes): ``y`` and ``s_out`` are written on the current
    stream; raises if the launch fails (a D the kernels are not built for,
    strides the instantiation cannot take)."""
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
    if not use_cuda_kernel("wkv6", *given):
        note_dispatch("wkv6", "ref")
        return wkv6_chunked(r, k, v, lw, u, s0)
    note_dispatch("wkv6", "cuda")
    if torch.is_grad_enabled() and any(x.requires_grad for x in given):
        return _WKV6.apply(r, k, v, lw, u, s0)
    return _forward_cuda(r, k, v, lw, u, s0)


def _forward_cuda(r, k, v, lw, u, s0):
    """The forward kernel on CUDA tensors: the plan, the copies it asks
    for, the launch, the padded head dim sliced off."""
    B, H, T, D = r.shape
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
    ins = [_dense32(x, pad, 1) if c else x
           for x, c in zip((r, k, v, lw), plan.copy)]
    return (*ins, _dense32(u, pad, 1),
            None if s0 is None else _dense32(s0, pad, 2))


def _dense32(x: torch.Tensor, pad: int, dims: int) -> torch.Tensor:
    """``x`` as contiguous float32 on a 16-byte base, its last ``dims``
    dims zero-padded by ``pad``; ``x`` itself where it already is."""
    if pad:  # a new tensor, contiguous on a fresh base
        return F.pad(x.to(torch.float32), (0, pad) * dims)
    if (x.dtype == torch.float32 and x.is_contiguous()
            and x.data_ptr() % 16 == 0):
        return x
    return x.to(torch.float32, memory_format=torch.contiguous_format,
                copy=True)


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------


class WKV6BwdPlan(NamedTuple):
    """How one backward call runs on the card: the variant (``"chunk"`` at
    head dim 64, ``"wide"`` above), the head dim its kernels are built for
    (D zero-padded up to it), and which of r, k, v, lw, dy are copied
    (converted to float32, padded, or made D-contiguous on a 16-byte base
    with strides of whole 16-byte pieces, as ``cp.async`` reads them)."""

    variant: str
    head_dim: int
    copy: Tuple[bool, bool, bool, bool, bool]


def plan_wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lw: torch.Tensor, dy: torch.Tensor) -> WKV6BwdPlan:
    """The plan for ``wkv6_bwd`` on the card; reads only shapes, strides,
    dtypes and base addresses."""
    D = r.shape[-1]
    variant, head_dim = ("chunk", 64) if D <= 64 else ("wide", -(-D // 4) * 4)
    return WKV6BwdPlan(variant, head_dim, tuple(
        D != head_dim or not _takes(x, 4) for x in (r, k, v, lw, dy)))


def _bwd_library():
    """The wkv6_bwd library, its three entries typed (built at first use)."""
    global _bwd_lib
    if _bwd_lib is None:
        from repro_torch.kernels.build import library

        lib = library("wkv6_bwd")
        lib.wkv6_bwd_launch.argtypes = (
            [ctypes.c_void_p] * 15 + [ctypes.c_longlong]
            + [ctypes.c_int] * 4
            + [ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p])
        lib.wkv6_bwd_launch.restype = ctypes.c_int
        lib.wkv6_bwd_kernels.argtypes = (
            [ctypes.c_int] * 10 + [ctypes.c_longlong, ctypes.c_void_p])
        lib.wkv6_bwd_kernels.restype = ctypes.c_int
        lib.wkv6_bwd_scratch_floats.argtypes = [ctypes.c_int] * 9
        lib.wkv6_bwd_scratch_floats.restype = ctypes.c_longlong
        _bwd_lib = lib
    return _bwd_lib


def bwd_schedule(plan: WKV6BwdPlan, B: int, H: int, T: int, want,
                 scratch_floats: Optional[int] = None
                 ) -> Tuple[int, dict]:
    """(floats of scratch, launches by name) of a backward call under
    ``plan`` asking for the gradients ``want`` (dr, dk, dv, dlw, du, ds0),
    as the library counts them (``wkv6_bwd_scratch_floats`` and
    ``wkv6_bwd_kernels``): the scratch it asks for unless
    ``scratch_floats`` is given, the launches that scratch makes.  Loads
    the library, so it runs where the kernels are built."""
    lib = _bwd_library()
    flags = [int(bool(x)) for x in want]
    if scratch_floats is None:
        scratch_floats = lib.wkv6_bwd_scratch_floats(
            B, H, T, plan.head_dim, *flags[:5])
    counts = (ctypes.c_int * 3)()
    if lib.wkv6_bwd_kernels(B, H, T, plan.head_dim, *flags, scratch_floats,
                            counts) != 0:
        raise ValueError(
            f"wkv6_bwd: {scratch_floats} floats of scratch hold less than "
            f"one value column group's partials at {(B, H, T, plan.head_dim)}")
    return scratch_floats, dict(zip(BWD_KERNELS[plan.variant], counts))


def launch_wkv6_bwd(
    r: torch.Tensor,    # (B, H, T, D) float32, D contiguous, 16-byte aligned
    k: torch.Tensor,    # (as r, k, v, lw and dy)
    v: torch.Tensor,
    lw: torch.Tensor,
    dy: torch.Tensor,
    u: torch.Tensor,    # (H, D) float32, contiguous
    s0: Optional[torch.Tensor],      # (B, H, D, D) float32 contiguous / None
    ds_fin: Optional[torch.Tensor],  # likewise
    dr: Optional[torch.Tensor],      # (B, H, T, D) float32 outs, D
    dk: Optional[torch.Tensor],      # contiguous, or None: not computed
    dv: Optional[torch.Tensor],
    dlw: Optional[torch.Tensor],
    du_part: Optional[torch.Tensor],  # (B, H, D) float32 out, or None
    ds0: Optional[torch.Tensor],      # (B, H, D, D) float32 out, or None
    scratch_floats: Optional[int] = None,
) -> None:
    """Launch B7's backward kernels on the current stream, those the
    library's ``wkv6_bwd_kernels`` counts for the outputs given.  D = 64
    (``"chunk"``): ``fwd`` (the chunks in order: dr, dlw's q and P_fin,
    du) where dr, dlw or du is asked for, then ``rev`` (in reverse: dk,
    dv, dlw, ds0) where dk, dv, dlw or ds0 is.  D > 64, a multiple of 4
    (``"wide"``): ``wide_fwd`` and ``wide_rev`` likewise, writing their
    partials into a scratch allocated here, then ``wide_reduce``, which
    adds them, once for each batch of value column groups the scratch
    holds: the library's size (within 1 GiB unless one group needs more)
    unless ``scratch_floats`` is given, the bits the same either way.
    The outputs given are written; raises if a launch fails (a D the
    kernels do not take, an input the kernel cannot read)."""
    lib = _bwd_library()
    B, H, T, D = r.shape
    index = r.get_device()
    want = tuple(x is not None for x in (dr, dk, dv, dlw, du_part, ds0))
    plan = plan_wkv6_bwd(r, k, v, lw, dy)
    floats, runs = bwd_schedule(plan, B, H, T, want, scratch_floats)
    scratch = (torch.empty(floats, dtype=torch.float32, device=r.device)
               if floats else None)
    tensors = (r, k, v, lw, dy, dr, dk, dv, dlw)
    strides = [s for x in tensors for s in (x.stride() if x is not None
                                            else (0, 0, 0, 1))]
    err = lib.wkv6_bwd_launch(
        *(0 if x is None else x.data_ptr()
          for x in (r, k, v, lw, dy, u, s0, ds_fin, dr, dk, dv, dlw,
                    du_part, ds0, scratch)),
        floats, B, H, T, D, _pack_bwd_strides(*strides),
        index, torch._C._cuda_getCurrentRawStream(index),
    )
    if err != 0:
        raise RuntimeError(
            f"wkv6_bwd kernel launch failed ({plan.variant}, D = {D}): CUDA "
            f"error {err}")
    for name, n in runs.items():
        if n:
            count_launch("wkv6_bwd", n, variant=name)


# the (b, h, t, d) strides of r, k, v, lw, dy, dr, dk, dv, dlw
_pack_bwd_strides = struct.Struct("36q").pack


def wkv6_bwd(
    r: torch.Tensor,    # (B, H, T, D)
    k: torch.Tensor,
    v: torch.Tensor,
    lw: torch.Tensor,   # (B, H, T, D) log decay, as given to wkv6
    u: torch.Tensor,    # (H, D)
    s0: Optional[torch.Tensor],      # (B, H, D, D) or None
    dy: torch.Tensor,                # (B, H, T, D) gradient of y
    ds_fin: Optional[torch.Tensor] = None,  # (B, H, D, D), or None: zero
    needs: Optional[Tuple[bool, ...]] = None,
) -> Tuple[Optional[torch.Tensor], ...]:
    """(dr, dk, dv, dlw, du, ds0) of :func:`wkv6`, each in its input's
    dtype (``ds0`` None when ``s0`` is): B7's backward kernel on CUDA
    tensors, :func:`~repro_torch.kernels.wkv6.ref.wkv6_bwd_ref` on CPU
    tensors.  ``needs`` (six flags, autograd's ``needs_input_grad``) leaves
    the gradients not asked for None, and uncomputed on the card.  On the
    card dr, dk, dv and dlw have their inputs' strides where those go in
    uncopied (the model's transposed views take them in place)."""
    B, H, T, D = r.shape
    if (any(x.shape != r.shape for x in (k, v, lw, dy)) or u.shape != (H, D)
            or any(x is not None and x.shape != (B, H, D, D)
                   for x in (s0, ds_fin))):
        shapes = [None if x is None else tuple(x.shape)
                  for x in (r, k, v, lw, u, s0, dy, ds_fin)]
        raise ValueError(
            f"wkv6_bwd: shapes {shapes} are not (r, k, v, lw, dy) (B, H, T, "
            "D), u (H, D), s0 and ds_fin (B, H, D, D)")
    needs = (True,) * 6 if needs is None else tuple(needs)
    given = [x for x in (r, k, v, lw, u, s0, dy, ds_fin) if x is not None]
    if not use_cuda_kernel("wkv6_bwd", *given):
        note_dispatch("wkv6_bwd", "ref")
        grads = wkv6_bwd_ref(r, k, v, lw, u, s0, dy, ds_fin)
        return tuple(g if n else None for g, n in zip(grads, needs))
    note_dispatch("wkv6_bwd", "cuda")
    plan = plan_wkv6_bwd(r, k, v, lw, dy)
    Dk = plan.head_dim
    pad = Dk - D
    ins = [_dense32(x, pad, 1) if c else x
           for x, c in zip((r, k, v, lw, dy), plan.copy)]
    want = needs[:5] + (needs[5] and s0 is not None,)
    f32 = dict(dtype=torch.float32, device=r.device)
    # each gradient in its input's layout (a transposed view stays one)
    outs = [torch.empty_like(x) if n else None
            for x, n in zip((ins[0], ins[1], ins[2], ins[3]), want)]
    du_part = torch.empty((B, H, Dk), **f32) if want[4] else None
    ds0 = torch.empty((B, H, Dk, Dk), **f32) if want[5] else None
    if B * H and any(want):
        launch_wkv6_bwd(
            *ins, _dense32(u, pad, 1),
            None if s0 is None else _dense32(s0, pad, 2),
            None if ds_fin is None else _dense32(ds_fin, pad, 2),
            *outs, du_part, ds0)

    def back(g, like, d):
        if g is None:
            return None
        if pad:
            g = g[(...,) + (slice(0, D),) * d]
        return g if g.dtype == like.dtype else g.to(like.dtype)

    dr, dk, dv, dlw = (back(g, x, 1) for g, x in zip(outs, (r, k, v, lw)))
    du = None if du_part is None else back(du_part.sum(0), u, 1)
    return dr, dk, dv, dlw, du, None if ds0 is None else back(ds0, s0, 2)


class _WKV6(torch.autograd.Function):
    """The forward kernel with B7's backward kernel as its gradient.  It
    saves only its inputs, which a checkpoint's recomputation reproduces;
    an output that autograd does not reach (the final state, in a loss)
    brings no gradient (None, not zeros)."""

    @staticmethod
    def forward(ctx, r, k, v, lw, u, s0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, lw, u, s0)
        return _forward_cuda(r, k, v, lw, u, s0)

    @staticmethod
    def backward(ctx, dy, ds_fin):
        r, k, v, lw, u, s0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        return wkv6_bwd(r, k, v, lw, u, s0, dy, ds_fin,
                        needs=ctx.needs_input_grad)
