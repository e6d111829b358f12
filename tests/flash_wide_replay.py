"""A torch replay of B6's two kernels above head dim 256
(``src/repro_torch/kernels/csrc/flash_attention.cu``, ``"wide"``),
written the way the kernels are written, so the CPU tests can hold their
schedule's arithmetic to the JAX package.

bf16 (``fa_wide_wgmma_kernel``): D in 64-column boxes (zeros past D, as
TMA fills them); a block owns a 64-row query tile and a column pass of up
to 8 output boxes; per 64-key tile (only those the causal limit and the
window can reach) consumer c forms the partial scores over boxes nb with
nb % 2 == c, and both take S = S_0 + S_1; the online softmax in log2
units (scale · log2 e folded in, alpha = 0 while the running max is still
-1e30), P rounded to bf16 for P V while l sums the float32 P; each output
box adds P V; the end divides by max(l, 1e-30) and rounds to bf16.

float32 (``fa_wide_simt_kernel``): a 32-row query tile and 32-key tiles;
the scores summed over D in 128-column slices, scaled, masked to -1e30;
the running max, P = exp(s - m), l = l · alpha + Σ P, acc = acc · alpha +
P V; the end divides by max(l, 1e-30).

Products run in torch's order (the kernels' in the tensor cores' or a
thread's), so the replay holds the schedule -- the D split and its sum,
the tiles, the online softmax and where it rounds -- not the bits.
"""

import math

import torch

NEG = -1.0e30
LOG2E = 1.4426950408889634


def _key_range(S, q0, rows, causal, window):
    lo, hi = 0, S
    if causal:
        hi = min(S, q0 + rows)
    if window is not None:
        lo = max(0, q0 - window + 1)
    return lo, hi


def _visible(S, q0, k0, rows, keys, causal, window):
    qp = torch.arange(q0, q0 + rows)[:, None]
    kp = torch.arange(k0, k0 + keys)[None, :]
    ok = torch.broadcast_to(kp < S, (rows, keys))
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & (kp > qp - window)
    return ok


def _tiles(x, rows, S):
    """x (..., S, D) zero-padded to a multiple of ``rows`` rows."""
    pad = (-S) % rows
    return torch.nn.functional.pad(x, (0, 0, 0, pad))


def wide_bf16(q, k, v, *, causal=True, window=None, scale=None):
    """The bf16 kernel's output (bf16) for bf16 q, k, v."""
    B, H, S, D = q.shape
    group = H // k.shape[1]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    nkb = -(-D // 64)
    DP = 64 * nkb
    f32 = torch.float32
    qf, kf, vf = (torch.nn.functional.pad(x.to(f32), (0, DP - D))
                  for x in (q, k, v))
    kf, vf = (x.repeat_interleave(group, dim=1) for x in (kf, vf))
    qf, kf, vf = (_tiles(x, 64, S) for x in (qf, kf, vf))
    out = torch.zeros((B, H, qf.shape[2], DP), dtype=f32)
    sl = scale * LOG2E
    for v0 in range(0, nkb, 8):          # column passes
        boxes = range(v0, min(nkb, v0 + 8))
        for q0 in range(0, S, 64):
            qt = qf[:, :, q0:q0 + 64]
            m = torch.full((B, H, 64, 1), NEG, dtype=f32)
            l = torch.zeros((B, H, 64, 1), dtype=f32)
            o = torch.zeros((B, H, 64, 64 * len(boxes)), dtype=f32)
            lo, hi = _key_range(S, q0, 64, causal, window)
            for k0 in range(lo // 64 * 64, hi, 64):
                kt = kf[:, :, k0:k0 + 64]
                part = []
                for c in (0, 1):         # each consumer's boxes of D
                    sc = torch.zeros((B, H, 64, 64), dtype=f32)
                    for nb in range(c, nkb, 2):
                        cols = slice(64 * nb, 64 * nb + 64)
                        sc = sc + qt[..., cols] @ kt[..., cols].transpose(-1, -2)
                    part.append(sc)
                s = part[0] + part[1]
                x = s * sl
                ok = _visible(S, q0, k0, 64, 64, causal, window)
                x = torch.where(ok, x, -math.inf)
                mn = torch.maximum(m, x.amax(-1, keepdim=True))
                a = torch.where(m == NEG, 0.0, torch.exp2(m - mn))
                m = mn
                p = torch.exp2(x - m)
                l = l * a + p.sum(-1, keepdim=True)
                pb = p.to(torch.bfloat16).to(f32)
                vt = vf[:, :, k0:k0 + 64]
                o = o * a
                for j, box in enumerate(boxes):
                    o[..., 64 * j:64 * j + 64] += (
                        pb @ vt[..., 64 * box:64 * box + 64])
            o = o / torch.clamp(l, min=1e-30)
            out[:, :, q0:q0 + 64, 64 * v0:64 * v0 + o.shape[-1]] = o
    return out[:, :, :S, :D].to(torch.bfloat16)


def wide_f32(q, k, v, *, causal=True, window=None, scale=None):
    """The float32 kernel's output for float32 q, k, v."""
    B, H, S, D = q.shape
    group = H // k.shape[1]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    kf, vf = (x.repeat_interleave(group, dim=1) for x in (k, v))
    qf, kf, vf = (_tiles(x, 32, S) for x in (q, kf, vf))
    out = torch.zeros_like(qf)
    for q0 in range(0, S, 32):
        qt = qf[:, :, q0:q0 + 32]
        m = torch.full((B, H, 32, 1), NEG)
        l = torch.zeros((B, H, 32, 1))
        acc = torch.zeros((B, H, 32, D))
        lo, hi = _key_range(S, q0, 32, causal, window)
        for k0 in range(lo // 32 * 32, hi, 32):
            kt = kf[:, :, k0:k0 + 32]
            s = torch.zeros((B, H, 32, 32))
            for c0 in range(0, D, 128):
                cols = slice(c0, c0 + 128)
                s = s + qt[..., cols] @ kt[..., cols].transpose(-1, -2)
            ok = _visible(S, q0, k0, 32, 32, causal, window)
            s = torch.where(ok, s * scale, NEG)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.where(ok, torch.exp(s - m_new), 0.0)
            alpha = torch.where(m == NEG, 0.0, torch.exp(m - m_new))
            l = l * alpha + p.sum(-1, keepdim=True)
            m = m_new
            acc = acc * alpha + p @ vf[:, :, k0:k0 + 32]
        out[:, :, q0:q0 + 32] = acc / torch.clamp(l, min=1e-30)
    return out[:, :, :S]


def replay(q, k, v, **kw):
    """The ``"wide"`` kernel of q's dtype, replayed."""
    if q.dtype == torch.bfloat16:
        return wide_bf16(q, k, v, **kw)
    return wide_f32(q, k, v, **kw)
