"""Dispatcher for the signature-embedding kernel.

``signature_embed(table, sig, weights, num_hashes=k)`` -> (N, D) in the
table's dtype: the k multi-hash ids of each signature
(:func:`repro_torch.core.signature.multi_hash_ids`), then the weighted
gather of the probed table rows.  CUDA tensors launch the hand-written
kernel (``kernels/csrc/signature_embed.cu``), which hashes the ids itself:
one launch, no eager hashing.  CPU tensors run ``multi_hash_ids`` and the
plain version (:mod:`.ref`), whose float32 result is cast to the table's
dtype.  Both give the same bits.  ``launch_signature_embed`` takes ids
already hashed (the kernel's second instantiation).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.hashing import _as_i32
from repro_torch.core.signature import multi_hash_ids
from repro_torch.kernels import count_launch, note_dispatch, use_cuda_kernel
from repro_torch.kernels.signature.ref import signature_embed_ref

__all__ = [
    "signature_embed", "launch_signature_embed", "launch_signature_embed_sig",
    "MAX_PROBES",
]

# the kernel keeps a row's ids and weights in 32 shared-memory slots a warp
MAX_PROBES = 32
# table dtype -> the kernel's dtype code (kernels/csrc/signature_embed.cu)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


def _launch(table, ids, sig, weights, out, k: int) -> None:
    global _fn
    if _fn is None:
        from repro_torch.kernels.build import library

        fn = library("signature_embed").signature_embed_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    V, D = table.shape
    # 16-byte loads and stores need D to fill whole 16-byte chunks and both
    # row arrays to start on a 16-byte boundary
    vec = int(
        (D * table.element_size()) % 16 == 0
        and table.data_ptr() % 16 == 0
        and out.data_ptr() % 16 == 0
    )
    dev = table.device
    err = _fn(
        table.data_ptr(), ids.data_ptr() if ids is not None else None,
        sig.data_ptr() if sig is not None else None, weights.data_ptr(),
        out.data_ptr(), out.shape[0], k, D, V, _DTYPE_CODES[table.dtype],
        vec, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    count_launch("signature_embed", variant="ids" if sig is None else "sig")
    if err != 0:
        raise RuntimeError(
            f"signature_embed kernel launch failed: CUDA error {err}"
        )


def launch_signature_embed(
    table: torch.Tensor,    # (V, D) float32 / bfloat16, contiguous
    ids: torch.Tensor,      # (N, k) int32, contiguous
    weights: torch.Tensor,  # (k,) float32
    out: torch.Tensor,      # (N, D) in the table's dtype
) -> None:
    """Launch the CUDA kernel on ids already hashed: ``out`` is written on
    the current stream; raises if the launch fails.  A row with an id
    outside [0, V) comes out NaN."""
    _launch(table, ids, None, weights, out, ids.shape[1])


def launch_signature_embed_sig(
    table: torch.Tensor,    # (V, D) float32 / bfloat16, contiguous
    sig: torch.Tensor,      # (N,) int32, contiguous
    weights: torch.Tensor,  # (k,) float32, contiguous
    out: torch.Tensor,      # (N, D) in the table's dtype
) -> None:
    """Launch the CUDA kernel on signatures: each row's ``k =
    len(weights)`` ids are hashed in the kernel; raises if the launch
    fails."""
    _launch(table, None, sig, weights, out, weights.shape[0])


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
    if not use_cuda_kernel("signature_embed", table, sig, weights):
        note_dispatch("signature_embed", "ref")
        ids = multi_hash_ids(sig, num_hashes, table.shape[0])
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
    if table.shape[0] < 1:
        raise ValueError("signature_embed: the table has no rows")
    out = torch.empty(
        (sig.shape[0], table.shape[1]), dtype=table.dtype, device=table.device
    )
    launch_signature_embed_sig(
        table, _as_i32(sig).contiguous(),
        weights.to(torch.float32).contiguous(), out,
    )
    return out
