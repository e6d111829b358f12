"""Dispatcher for the WKV6 scan (kernel B7).

``wkv6(r, k, v, lw, u, s0=None)`` -> (y (B, H, T, D) in ``r``'s dtype,
final state (B, H, D, D) float32).  CUDA tensors launch the hand-written
kernel (``kernels/csrc/wkv6.cu``, which masks a ragged last chunk itself);
CPU tensors run :func:`wkv6_chunked`, the plain twin of the reference's
``_wkv6_xla_chunked``: the same chunk-16 factorization, its scan over
chunks a Python loop, T padded to a chunk multiple with identity rows
(r = k = v = 0, lw = 0), which leave y and the carried state untouched.
The reference's ``impl`` switch (Pallas or XLA, two lowerings of one
function on the TPU) has no counterpart: where the tensors live decides.

Tolerances (``tests/test_torch_rwkv6.py``): :func:`wkv6_chunked` and the
recurrence :func:`~repro_torch.kernels.wkv6.ref.wkv6_ref` are held to the
reference's recurrence at ``atol = rtol = 5e-4``, the reference's own
(``tests/test_kernels.py``); :func:`wkv6_chunked` is held to the
reference's ``impl="xla"`` at ``atol = rtol = 2e-5`` (the same arithmetic,
the matrix products summed in another order).

No gradient: the kernel's backward comes with the training slice, so
``wkv6`` raises when autograd would record it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import count_launch, note_dispatch, use_cuda_kernel
from repro_torch.kernels.wkv6.ref import LOG_W_MIN

__all__ = ["wkv6", "wkv6_chunked", "launch_wkv6", "CHUNK", "KERNEL_HEAD_DIMS"]

CHUNK = 16
# head dims the CUDA kernel is built for (4·D threads a block)
KERNEL_HEAD_DIMS = (16, 32, 64)

_argtypes_set = False


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


def launch_wkv6(
    r: torch.Tensor,    # (B, H, T, D) float32, contiguous (as k, v, lw)
    k: torch.Tensor,
    v: torch.Tensor,
    lw: torch.Tensor,
    u: torch.Tensor,    # (H, D) float32, contiguous
    s0: Optional[torch.Tensor],  # (B, H, D, D) float32, contiguous, or None
    y: torch.Tensor,    # (B, H, T, D) float32 out
    s_out: torch.Tensor,  # (B, H, D, D) float32 out
) -> None:
    """Launch the CUDA kernel: ``y`` and ``s_out`` are written on the
    current stream; raises if the launch fails."""
    global _argtypes_set
    from repro_torch.kernels.build import library

    fn = library("wkv6").wkv6_launch
    if not _argtypes_set:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        _argtypes_set = True
    B, H, T, D = r.shape
    dev = r.device
    err = fn(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
        u.data_ptr(), 0 if s0 is None else s0.data_ptr(),
        y.data_ptr(), s_out.data_ptr(), B, H, T, D, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    count_launch("wkv6")
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {err}")


def wkv6(
    r: torch.Tensor,    # (B, H, T, D)
    k: torch.Tensor,
    v: torch.Tensor,
    lw: torch.Tensor,   # (B, H, T, D) log decay (clamped internally)
    u: torch.Tensor,    # (H, D)
    s0: Optional[torch.Tensor] = None,  # (B, H, D, D)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, H, T, D) in ``r``'s dtype, final state (B, H, D, D) float32)."""
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
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"wkv6: the kernel takes head dims {KERNEL_HEAD_DIMS}, got {D}"
        )

    def f32(x):
        return x.to(torch.float32).contiguous()

    y = torch.empty((B, H, T, D), dtype=torch.float32, device=r.device)
    s_out = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    launch_wkv6(f32(r), f32(k), f32(v), f32(lw), f32(u),
                None if s0 is None else f32(s0), y, s_out)
    return y.to(r.dtype), s_out
