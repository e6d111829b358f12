"""Dispatcher for the signature-embedding kernel.

``signature_embed(table, sig, weights, num_hashes=k)`` -> (N, D) in the
table's dtype: the k multi-hash ids of each signature
(:func:`repro_torch.core.signature.multi_hash_ids`, torch ops, as the
reference's wrapper computes them with XLA), then the weighted gather of
the probed table rows.  CUDA tensors launch the hand-written kernel
(``kernels/csrc/signature_embed.cu``); CPU tensors run the plain version
(:mod:`.ref`) and cast its float32 result to the table's dtype.  Both
give the same bits.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.signature import multi_hash_ids
from repro_torch.kernels import count_launch, note_dispatch, use_cuda_kernel
from repro_torch.kernels.signature.ref import signature_embed_ref

__all__ = ["signature_embed", "launch_signature_embed", "MAX_PROBES"]

# the kernel keeps a row's ids and weights in 32 shared-memory slots a warp
MAX_PROBES = 32
# table dtype -> the kernel's dtype code (kernels/csrc/signature_embed.cu)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_argtypes_set = False


def launch_signature_embed(
    table: torch.Tensor,    # (V, D) float32 / bfloat16, contiguous
    ids: torch.Tensor,      # (N, k) int32, contiguous
    weights: torch.Tensor,  # (k,) float32
    out: torch.Tensor,      # (N, D) in the table's dtype
) -> None:
    """Launch the CUDA kernel: ``out`` is written on the current stream;
    raises if the launch fails.  A row with an id outside [0, V) comes
    out NaN."""
    global _argtypes_set
    from repro_torch.kernels.build import library

    fn = library("signature_embed").signature_embed_launch
    if not _argtypes_set:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        _argtypes_set = True
    V, D = table.shape
    n, k = ids.shape
    # 16-byte loads and stores need D to fill whole 16-byte chunks and both
    # row arrays to start on a 16-byte boundary
    vec = int(
        (D * table.element_size()) % 16 == 0
        and table.data_ptr() % 16 == 0
        and out.data_ptr() % 16 == 0
    )
    dev = table.device
    err = fn(
        table.data_ptr(), ids.data_ptr(), weights.data_ptr(), out.data_ptr(),
        n, k, D, V, _DTYPE_CODES[table.dtype], vec, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    count_launch("signature_embed")
    if err != 0:
        raise RuntimeError(
            f"signature_embed kernel launch failed: CUDA error {err}"
        )


def signature_embed(
    table: torch.Tensor,    # (V, D)
    sig: torch.Tensor,      # (N,) int32 signatures
    weights: torch.Tensor,  # (num_hashes,)
    *,
    num_hashes: int = 2,
) -> torch.Tensor:
    """(N, D) in ``table.dtype``: ``sum_j w_j * table[h_j(sig)]`` with the
    k probes added in order in float32."""
    if sig.dim() != 1 or table.dim() != 2:
        raise ValueError(
            f"signature_embed: sig must be 1-D and table 2-D, got "
            f"{tuple(sig.shape)} and {tuple(table.shape)}"
        )
    if weights.shape != (num_hashes,):
        raise ValueError(
            f"signature_embed: weights must have shape ({num_hashes},), got "
            f"{tuple(weights.shape)}"
        )
    ids = multi_hash_ids(sig, num_hashes, table.shape[0])
    if not use_cuda_kernel("signature_embed", table, ids, weights):
        note_dispatch("signature_embed", "ref")
        return signature_embed_ref(table, ids, weights).to(table.dtype)
    note_dispatch("signature_embed", "cuda")
    if table.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"signature_embed: the kernel takes float32 or bfloat16 tables, "
            f"got {table.dtype}"
        )
    if not 1 <= num_hashes <= MAX_PROBES:
        raise ValueError(
            f"signature_embed: num_hashes must be in [1, {MAX_PROBES}], got "
            f"{num_hashes}"
        )
    if not table.is_contiguous():
        raise ValueError("signature_embed: table must be contiguous")
    out = torch.empty(
        (ids.shape[0], table.shape[1]), dtype=table.dtype, device=table.device
    )
    launch_signature_embed(
        table, ids.contiguous(), weights.to(torch.float32).contiguous(), out
    )
    return out
