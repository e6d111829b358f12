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

The backward's two schedules (``flash_attention_bwd.cu``, ``"wide"``):

bf16 (``bwd_dq_wide_kernel``, ``bwd_dkdv_wide_kernel``): Δ = rowsum(dO ∘
O); every score product S = Q Kᵀ, dP = dO Vᵀ (dQ) or Sᵀ = K Qᵀ, dPᵀ = V
dOᵀ (dK / dV) summed over D's 64-column boxes as two consumers' partials
and their sum; P = exp2(S · scale · log2 e − lse · log2 e) from the
forward's lse, masked; dS = P ∘ (dP − Δ); P and dS rounded to bf16 for
their products; dQ in column passes of 512 over the visible 64-key tiles,
dK and dV in passes of 256 over the visible 64-row query tiles, each pass
forming its scores again; each query head's float32 partial dK, dV, then
the group summed in head order.

float32 (``bwd_dq_wide_simt_kernel``, ``bwd_dkdv_wide_simt_kernel``): the
row statistics (m, l) over 32-key tiles with the scores summed over D in
64-column slices; P = exp(s · scale − m) / l, dS = P ∘ (dP − Δ); dQ and
dK, dV in column passes of 512, the group's heads in order.

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


def _split_scores(a, b, nkb):
    """a bᵀ over D's 64-column boxes as the two consumers form it: each
    its boxes nb = c, c + 2, ..., then the sum of the two partials."""
    part = []
    for c in (0, 1):
        x = torch.zeros(a.shape[:-1] + (b.shape[-2],), dtype=a.dtype)
        for nb in range(c, nkb, 2):
            cols = slice(64 * nb, 64 * nb + 64)
            x = x + a[..., cols] @ b[..., cols].transpose(-1, -2)
        part.append(x)
    return part[0] + part[1]


def wide_bwd_bf16(q, k, v, o, do, lse, *, causal=True, window=None,
                  scale=None):
    """The bf16 backward kernels' (dq, dk, dv) (bf16) for bf16 q, k, v,
    o, dO and the forward's float32 lse."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    group = H // Hkv
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    nkb = -(-D // 64)
    DP = 64 * nkb
    f32 = torch.float32
    qf, kf, vf, of, dof = (torch.nn.functional.pad(x.to(f32), (0, DP - D))
                           for x in (q, k, v, o, do))
    delta = (dof * of).sum(-1)
    kf, vf = (x.repeat_interleave(group, dim=1) for x in (kf, vf))
    qf, kf, vf, dof = (_tiles(x, 64, S) for x in (qf, kf, vf, dof))
    n = qf.shape[2]
    ls = torch.nn.functional.pad(lse * LOG2E, (0, n - S), value=math.inf)
    dl = torch.nn.functional.pad(delta, (0, n - S))
    sl = scale * LOG2E
    bf = torch.bfloat16

    dq = torch.zeros((B, H, n, DP), dtype=f32)
    for v0 in range(0, nkb, 8):
        cols = slice(64 * v0, 64 * min(nkb, v0 + 8))
        for q0 in range(0, S, 64):
            rows = slice(q0, q0 + 64)
            lo, hi = _key_range(S, q0, 64, causal, window)
            for k0 in range(lo // 64 * 64, hi, 64):
                keys = slice(k0, k0 + 64)
                ok = _visible(S, q0, k0, 64, 64, causal, window)
                s = _split_scores(qf[:, :, rows], kf[:, :, keys], nkb)
                p = torch.where(ok, torch.exp2(s * sl - ls[:, :, rows, None]),
                                0.0)
                dp = _split_scores(dof[:, :, rows], vf[:, :, keys], nkb)
                ds = (p * (dp - dl[:, :, rows, None])).to(bf).to(f32)
                dq[:, :, rows, cols] += ds @ kf[:, :, keys, cols]
    dk = torch.zeros((B, H, n, DP), dtype=f32)
    dv = torch.zeros((B, H, n, DP), dtype=f32)
    for v0 in range(0, nkb, 4):
        cols = slice(64 * v0, 64 * min(nkb, v0 + 4))
        for j0 in range(0, S, 64):
            keys = slice(j0, j0 + 64)
            j_last = min(j0 + 64, S) - 1
            i_lo = j0 if causal else 0
            i_hi = min(S, j_last + window) if window is not None else S
            for i0 in range(i_lo // 64 * 64, i_hi, 64):
                rows = slice(i0, i0 + 64)
                ok = _visible(S, i0, j0, 64, 64, causal, window).T
                st = _split_scores(kf[:, :, keys], qf[:, :, rows], nkb)
                pt = torch.where(
                    ok, torch.exp2(st * sl - ls[:, :, None, rows]), 0.0)
                dpt = _split_scores(vf[:, :, keys], dof[:, :, rows], nkb)
                dst = pt * (dpt - dl[:, :, None, rows])
                dv[:, :, keys, cols] += pt.to(bf).to(f32) @ dof[:, :, rows, cols]
                dk[:, :, keys, cols] += dst.to(bf).to(f32) @ qf[:, :, rows, cols]
    dk = scale * dk
    # the group's heads in ascending order
    dk, dv = (x.view(B, Hkv, group, n, DP) for x in (dk, dv))
    sk, sv = dk[:, :, 0], dv[:, :, 0]
    for g in range(1, group):
        sk, sv = sk + dk[:, :, g], sv + dv[:, :, g]
    return ((scale * dq)[:, :, :S, :D].to(bf), sk[:, :, :S, :D].to(bf),
            sv[:, :, :S, :D].to(bf))


def wide_bwd_f32(q, k, v, o, do, *, causal=True, window=None, scale=None):
    """The float32 backward kernels' (dq, dk, dv) for float32 inputs."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    group = H // Hkv
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    delta = (do * o).sum(-1)
    kf, vf = (x.repeat_interleave(group, dim=1) for x in (k, v))
    qf, kf, vf, dof = (_tiles(x, 32, S) for x in (q, kf, vf, do))
    n = qf.shape[2]
    dl = torch.nn.functional.pad(delta, (0, n - S))

    def scores(a, b):
        x = torch.zeros(a.shape[:-1] + (b.shape[-2],))
        for c0 in range(0, D, 64):
            cols = slice(c0, c0 + 64)
            x = x + a[..., cols] @ b[..., cols].transpose(-1, -2)
        return x

    def key_tiles(q0):
        lo, hi = 0, (min(q0 + 32, S) if causal else S)
        if window is not None:
            lo = max(0, q0 - window + 1)
        return range(lo, hi, 32)

    # pass 1 of the dQ kernel: each row's m and l
    m = torch.full((B, H, n, 1), -math.inf)
    l = torch.zeros((B, H, n, 1))
    for q0 in range(0, S, 32):
        rows = slice(q0, q0 + 32)
        for j0 in key_tiles(q0):
            ok = _visible(S, q0, j0, 32, 32, causal, window)
            s = torch.where(ok, scores(qf[:, :, rows], kf[:, :, j0:j0 + 32])
                            * scale, -math.inf)
            mr = m[:, :, rows]
            m_new = torch.maximum(mr, s.amax(-1, keepdim=True))
            none = m_new == -math.inf
            part = torch.exp(s - torch.where(none, 0.0, m_new)).sum(
                -1, keepdim=True)
            l[:, :, rows] = torch.where(
                none, 0.0, l[:, :, rows] * torch.exp(mr - m_new) + part)
            m[:, :, rows] = m_new

    def weights(i0, j0):
        rows = slice(i0, i0 + 32)
        ok = _visible(S, i0, j0, 32, 32, causal, window) & (l[:, :, rows] > 0)
        s = scores(qf[:, :, rows], kf[:, :, j0:j0 + 32])
        p = torch.where(ok, torch.exp(s * scale - m[:, :, rows])
                        / l[:, :, rows], 0.0)
        dp = scores(dof[:, :, rows], vf[:, :, j0:j0 + 32])
        return p, p * (dp - dl[:, :, rows, None])

    dq = torch.zeros((B, H, n, D))
    dk = torch.zeros((B, H, n, D))
    dv = torch.zeros((B, H, n, D))
    for d0 in range(0, D, 512):           # column passes
        cols = slice(d0, d0 + 512)
        for i0 in range(0, S, 32):
            for j0 in key_tiles(i0):
                p, ds = weights(i0, j0)
                dq[:, :, i0:i0 + 32, cols] += ds @ kf[:, :, j0:j0 + 32, cols]
                keys = slice(j0, j0 + 32)
                dv[:, :, keys, cols] += p.transpose(-1, -2) @ dof[:, :, i0:i0 + 32, cols]
                dk[:, :, keys, cols] += ds.transpose(-1, -2) @ qf[:, :, i0:i0 + 32, cols]
    dk, dv = (x.view(B, Hkv, group, n, D) for x in (scale * dk, dv))
    sk, sv = dk[:, :, 0], dv[:, :, 0]
    for g in range(1, group):
        sk, sv = sk + dk[:, :, g], sv + dv[:, :, g]
    return (scale * dq)[:, :, :S], sk[:, :, :S], sv[:, :, :S]
