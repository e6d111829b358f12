"""Plain PyTorch version of the signature-embedding kernel.

``signature_embed_ref`` is the kernel's contract, defined as the
reference package's Pallas body computes it
(``repro/kernels/signature/signature.py::_sig_embed_kernel``): the output
row starts at 0.0 and the k probed table rows are added in probe order,
each as a separate float32 multiply and a separate add (no fused
multiply-add).  The result is float32; the dispatcher casts it to the
table's dtype, as the reference's wrapper does.  The CUDA kernel must
equal it bit for bit.
"""

from __future__ import annotations

import torch

__all__ = ["signature_embed_ref"]


def signature_embed_ref(
    table: torch.Tensor,    # (V, D) float32 or bfloat16
    ids: torch.Tensor,      # (N, k) int32 rows in [0, V)
    weights: torch.Tensor,  # (k,) combine weights
) -> torch.Tensor:
    """(N, D) float32: ``sum_j w_j * f32(table[ids[:, j]])``, in order."""
    w = weights.to(torch.float32)
    out = torch.zeros(
        (ids.shape[0], table.shape[1]), dtype=torch.float32,
        device=table.device,
    )
    for j in range(ids.shape[1]):
        out = out + w[j] * table[ids[:, j].long()].to(torch.float32)
    return out
