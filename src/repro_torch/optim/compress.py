"""int8 error-feedback gradient compression.

The reference package's ``repro.optim.compress``: each leaf flattened in
float32, zero-padded to blocks of 256, scaled per block by max |x| / 127
(at least 1e-12), rounded half to even and clipped to [-127, 127].  Error
feedback adds each leaf's residual ``g - dequant(quant(g))`` to the next
step's gradient.  The arithmetic is the reference's, so the two packages
agree bit for bit.  On the reference's multi-pod meshes the int8 payload
is what crosses the pod axis; on one card the round trip is what remains
(``TrainSettings.compress_pod_grads``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["quantize_int8", "dequantize_int8", "ef_compress_tree", "BLOCK"]

BLOCK = 256


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8 quantization: (q (nb, 256) int8, scales
    (nb, 1) float32)."""
    flat = x.to(torch.float32).reshape(-1)
    flat = F.pad(flat, (0, (-flat.shape[0]) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape: Sequence[int],
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[:n].reshape(tuple(shape)).to(dtype)


def ef_compress_tree(
    grads: Mapping[str, torch.Tensor], residual: Mapping[str, torch.Tensor]
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Quantize ``grads + residual`` leaf by leaf: (the dequantized
    gradients for the optimizer, the new residuals)."""
    deq, res = {}, {}
    for n, g in grads.items():
        gf = g.to(torch.float32) + residual[n]
        q, s = quantize_int8(gf)
        deq[n] = dequantize_int8(q, s, g.shape)
        res[n] = gf - deq[n]
    return deq, res
