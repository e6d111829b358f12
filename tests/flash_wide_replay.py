"""A torch replay of B6's two kernels above head dim 256
(``src/repro_torch/kernels/csrc/flash_attention.cu``, ``"wide"``), of its
float32 forward up to 256 (``"f32"``) with its log-sum-exp, and of the
backward kernels (``flash_attention_bwd.cu``), written the way the
kernels are written, so the CPU tests can hold their schedules'
arithmetic to the JAX package.

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

float32 up to head dim 256 (``fa_f32_kernel``): D padded to a multiple
of 4; the tiles of ``F32_FWD_TILES`` (128 query rows over 32- or 64-key
tiles up to D = 128, 64 rows above, 32 rows x 16 keys for short
sequences); every product in 3xTF32 with the backward's split (tf32.cuh's
``split_trunc``: hi = x with its 13 low bits cleared, lo the remainder
read with its own 13 low bits dropped); above D = 128 each score the sum
of two warps' partials over D's halves; the same online softmax.  Both float32 instantiations write
each row's lse = m + ln l under autograd, +inf where l = 0
(:func:`f32_forward`).

The backward's schedules (``flash_attention_bwd.cu``):

bf16 (``bwd_dq_wide_kernel``, ``bwd_dkdv_wide_kernel``): Δ = rowsum(dO ∘
O); every score product S = Q Kᵀ, dP = dO Vᵀ (dQ) or Sᵀ = K Qᵀ, dPᵀ = V
dOᵀ (dK / dV) summed over D's 64-column boxes as two consumers' partials
and their sum; P = exp2(S · scale · log2 e − lse · log2 e) from the
forward's lse, masked; dS = P ∘ (dP − Δ); P and dS rounded to bf16 for
their products; dQ in column passes of 512 over the visible 64-key tiles,
dK and dV in passes of 256 over the visible 64-row query tiles, each pass
forming its scores again; each query head's float32 partial dK, dV, then
the group summed in head order.

float32 (``bwd_dq_f32_kernel``, ``bwd_dkdv_f32_kernel`` and their
``_wide`` builds, :func:`f32_bwd`): every product 3xTF32 -- each operand
split into a TF32 hi part (the bits with the 13 low ones cleared) and the
remainder, which the tensor core reads with its 13 low bits dropped, and
lo·hi + hi·lo + hi·hi summed in float32 -- emulated here
on the int32 bits; D padded with zeros to a multiple of 4; Δ = rowsum(dO
∘ O) formed as each kernel forms its dP (the dQ kernel's as dO Oᵀ, the
dK / dV kernel's as O dOᵀ, the diagonal of the same chains), so dP − Δ
is 0 where a key's V is the row's O; a dQ block per (b, h, query tile)
over the visible key tiles, a dK /
dV block per (b, query head, key tile) over the visible query tiles (the
tiles of ``F32_TILES``); each score product contracted over D by W warps,
warp j over its share of each staged chunk of columns, and the W partials
summed in warp order; P = exp(scale · S − lse) from the forward's lse,
masked, dS = P ∘ (dP − Δ); the output columns in passes of 512 above
head dim 256 (each pass forming its scores again); with G > 1 each query
head's partial dK (scaled), dV, then the group summed in head order.

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


def replay(q, k, v, **kw):
    """The ``"wide"`` kernel of q's dtype, replayed."""
    if q.dtype == torch.bfloat16:
        return wide_bf16(q, k, v, **kw)
    return f32_forward(q, k, v, **kw)[0]


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


# float32 backward tiles, as flash_attention_bwd.cu instantiates them: the
# head-dim tile (512: "f32 wide"; "short": D <= 64 and S <= 96) -> for dQ
# and for dK / dV (rows of a block, rows of a streamed tile, warps
# splitting D, columns staged at a time); the wide kernels stage D in
# chunks of the last entry
F32_TILES = {
    32: ((64, 64, 1, 32), (64, 64, 1, 32)),
    64: ((64, 64, 1, 64), (64, 64, 1, 64)),
    128: ((128, 32, 1, 128), (128, 32, 1, 128)),
    256: ((64, 32, 1, 256), (32, 32, 2, 256)),
    512: ((32, 32, 4, 256), (32, 32, 4, 128)),
}
F32_SHORT_S = 96


def f32_tile(D):
    """The float32 backward's head-dim tile for head dim ``D`` (padded to
    a multiple of 4): 32, 64, 128 or 256, or 512 above 256 (``wide``)."""
    D = -(-D // 4) * 4
    return 512 if D > 256 else next(t for t in (32, 64, 128, 256) if D <= t)


def f32_tiles(D, S):
    """``F32_TILES``' entry for head dim ``D`` at sequence length ``S``:
    at D <= 64 a sequence of up to ``F32_SHORT_S`` rows takes 32-row tiles
    both ways (the columns and warps unchanged)."""
    tile = f32_tile(D)
    q, k = F32_TILES[tile]
    if tile <= 64 and S <= F32_SHORT_S:
        return (32, 32) + q[2:], (32, 32) + k[2:]
    return q, k


def tf32_split(x, rounded=False):
    """(hi, lo) of float32 ``x`` as the tensor core reads them: hi = x with
    its 13 low bits cleared (TF32) -- or, ``rounded``, x rounded to TF32
    first (half a TF32 ulp added to the bits: tf32.cuh's ``split_tf32``) --
    lo = the exact remainder with its own 13 low bits dropped."""
    bits = x.view(torch.int32)
    if rounded:
        bits = bits + 0x1000
    hi = (bits & -0x2000).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & -0x2000).view(torch.float32)
    return hi, lo


def mm3(a, b, rounded=False):
    """a @ b in 3xTF32: lo·hi + hi·lo + hi·hi, each in float32."""
    ah, al = tf32_split(a.contiguous(), rounded)
    bh, bl = tf32_split(b.contiguous(), rounded)
    return al @ bh + ah @ bl + ah @ bh


# float32 forward tiles ("f32", fa_f32_kernel), as flash_attention.cu's
# F32FwdCfg instantiates them: the head-dim tile -> (query rows of a
# block, keys of a tile, warps splitting D); at tiles up to 64 a sequence
# of up to F32_SHORT_S rows takes 32-row tiles of 16 keys
F32_FWD_TILES = {
    32: (128, 32, 1), 64: (128, 32, 1), 96: (128, 64, 1), 128: (128, 32, 1),
    160: (64, 32, 2), 192: (64, 32, 2), 224: (64, 16, 2), 256: (64, 16, 2),
}


def f32_fwd_tiles(D, S):
    """(head-dim tile, ``F32_FWD_TILES``' entry) of the float32 forward at
    head dim ``D`` <= 256 (padded to a multiple of 4) and length ``S``."""
    tile = -(-(-(-D // 4) * 4) // 32) * 32
    if tile <= 64 and S <= F32_SHORT_S:
        return tile, (32, 16, 1)
    return tile, F32_FWD_TILES[tile]


def f32_forward(q, k, v, *, causal=True, window=None, scale=None,
                rounded=False):
    """(o, lse) of the float32 forward kernels' schedule: up to head dim
    256 ``fa_f32_kernel`` -- D padded with zeros to a multiple of 4, the
    tiles of ``F32_FWD_TILES``, S = Q Kᵀ and O += P V in 3xTF32 with the
    truncated hi part (or, ``rounded``, the rounded one), above D = 128
    each score the sum of two warps' partials over D's halves; above 256
    ``fa_wide_simt_kernel`` -- 32-row tiles, the scores summed over D in
    128-column slices, float32 products.  Both
    run the online softmax (scores scaled, masked to -1e30, the running
    max, P = exp(s - m), masked weights 0, alpha = 0 while the max is
    -1e30, l = l · alpha + Σ P, acc = acc · alpha + P V, o = acc /
    max(l, 1e-30)) and give lse = m + ln l, +inf where l = 0."""
    B, H, S, D0 = q.shape
    group = H // k.shape[1]
    scale = 1.0 / math.sqrt(D0) if scale is None else scale
    if D0 > 256:
        rows, keys, sl = 32, 32, 128
        D = D0
        halves = [slice(c, c + sl) for c in range(0, D, sl)]
        mm = torch.matmul
    else:
        tile, (rows, keys, w) = f32_fwd_tiles(D0, S)
        D = -(-D0 // 4) * 4
        # warp j's share of the columns: [j tile / w, (j + 1) tile / w)
        halves = [slice(c, min(D, c + tile // w))
                  for c in range(0, D, tile // w)]
        mm = lambda a, b: mm3(a, b, rounded)  # noqa: E731
    pad = lambda x: torch.nn.functional.pad(x, (0, D - D0))  # noqa: E731
    kf, vf = (pad(x).repeat_interleave(group, dim=1) for x in (k, v))
    qf, kf, vf = (_tiles(x, max(rows, keys), S) for x in (pad(q), kf, vf))
    out = torch.zeros_like(qf)
    lse = torch.zeros(qf.shape[:3])
    for q0 in range(0, S, rows):
        qt = qf[:, :, q0:q0 + rows]
        m = torch.full((B, H, rows, 1), NEG)
        l = torch.zeros((B, H, rows, 1))
        acc = torch.zeros((B, H, rows, D))
        lo, hi = _key_range(S, q0, rows, causal, window)
        for k0 in range(lo // keys * keys, hi if hi > lo else 0, keys):
            kt = kf[:, :, k0:k0 + keys]
            s = torch.zeros((B, H, rows, keys))
            for cols in halves:
                s = s + mm(qt[..., cols], kt[..., cols].transpose(-1, -2))
            ok = _visible(S, q0, k0, rows, keys, causal, window)
            s = torch.where(ok, s * scale, NEG)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.where(ok, torch.exp(s - m_new), 0.0)
            alpha = torch.where(m == NEG, 0.0, torch.exp(m - m_new))
            l = l * alpha + p.sum(-1, keepdim=True)
            m = m_new
            acc = acc * alpha + mm(p, vf[:, :, k0:k0 + keys])
        out[:, :, q0:q0 + rows] = acc / torch.clamp(l, min=1e-30)
        lse[:, :, q0:q0 + rows] = torch.where(
            l > 0, m + torch.log(l), math.inf)[..., 0]
    return out[:, :, :S, :D0], lse[:, :, :S]


def f32_bwd(q, k, v, o, do, lse, *, causal=True, window=None, scale=None):
    """The float32 backward kernels' (dq, dk, dv) for float32 q, k, v, o,
    dO and the forward's lse: the tiles of ``F32_TILES``, every product in
    3xTF32, each score contracted by the row group's warps over their
    shares of each chunk and the partials summed in warp order."""
    B, H, S, D0 = q.shape
    Hkv = k.shape[1]
    group = H // Hkv
    scale = 1.0 / math.sqrt(D0) if scale is None else scale
    D = -(-D0 // 4) * 4
    wide = f32_tile(D) == 512
    (bmq, bnq, wq, dtq), (bmk, bnk, wk, dtk) = f32_tiles(D, S)
    pad = lambda x: torch.nn.functional.pad(x, (0, D - D0))  # noqa: E731
    qf, kf, vf, of, dof = (pad(x) for x in (q, k, v, o, do))
    kf, vf = (x.repeat_interleave(group, dim=1) for x in (kf, vf))
    n = -(-S // 128) * 128  # every tile of 32, 64 or 128 rows fits
    qf, kf, vf, of, dof = (_tiles(x, 128, S) for x in (qf, kf, vf, of, dof))
    ls = torch.nn.functional.pad(lse, (0, n - S), value=math.inf)

    def scores(a, b, w, dt):
        """a bᵀ: warp j's partial over columns [j dt / w, (j + 1) dt / w)
        of each chunk of dt columns, the partials summed in warp order."""
        part = []
        for j in range(w):
            x = torch.zeros(a.shape[:-1] + (b.shape[-2],))
            for c0 in range(0, D, dt):
                cols = slice(c0 + j * dt // w, min(D, c0 + (j + 1) * dt // w))
                if cols.start < cols.stop:
                    x = x + mm3(a[..., cols], b[..., cols].transpose(-1, -2))
            part.append(x)
        total = part[0]
        for x in part[1:]:
            total = total + x
        return total

    # each kernel's Δ, the diagonal of its own score chains on dO and O
    dl = torch.diagonal(scores(dof, of, wq, dtq), dim1=-2, dim2=-1)
    dlt = torch.diagonal(scores(of, dof, wk, dtk), dim1=-2, dim2=-1)
    passes = [slice(c, c + 512) for c in range(0, D, 512)] if wide else [
        slice(0, D)]
    dq = torch.zeros((B, H, n, D))
    for cols in passes:
        for q0 in range(0, S, bmq):
            rows = slice(q0, q0 + bmq)
            lo, hi = _key_range(S, q0, bmq, causal, window)
            for k0 in range(lo // bnq * bnq, hi if hi > lo else 0, bnq):
                keys = slice(k0, k0 + bnq)
                ok = _visible(S, q0, k0, bmq, bnq, causal, window)
                s = scores(qf[:, :, rows], kf[:, :, keys], wq, dtq)
                dp = scores(dof[:, :, rows], vf[:, :, keys], wq, dtq)
                p = torch.where(ok, torch.exp(scale * s - ls[:, :, rows, None]),
                                0.0)
                ds = p * (dp - dl[:, :, rows, None])
                dq[:, :, rows, cols] += mm3(ds, kf[:, :, keys, cols])
    dk = torch.zeros((B, H, n, D))
    dv = torch.zeros((B, H, n, D))
    for cols in passes:
        for j0 in range(0, S, bmk):
            keys = slice(j0, j0 + bmk)
            j_last = min(j0 + bmk, S) - 1
            i_lo = j0 if causal else 0
            i_hi = min(S, j_last + window) if window is not None else S
            for i0 in range(i_lo // bnk * bnk, i_hi if i_hi > i_lo else 0,
                            bnk):
                rows = slice(i0, i0 + bnk)
                ok = _visible(S, i0, j0, bnk, bmk, causal, window).T
                st = scores(kf[:, :, keys], qf[:, :, rows], wk, dtk)
                dpt = scores(vf[:, :, keys], dof[:, :, rows], wk, dtk)
                pt = torch.where(ok, torch.exp(scale * st - ls[:, :, None, rows]),
                                 0.0)
                dst = pt * (dpt - dlt[:, :, None, rows])
                dv[:, :, keys, cols] += mm3(pt, dof[:, :, rows, cols])
                dk[:, :, keys, cols] += mm3(dst, qf[:, :, rows, cols])
    dk = scale * dk
    # the group's heads in ascending order
    dk, dv = (x.view(B, Hkv, group, n, D) for x in (dk, dv))
    sk, sv = dk[:, :, 0], dv[:, :, 0]
    for g in range(1, group):
        sk, sv = sk + dk[:, :, g], sv + dv[:, :, g]
    return ((scale * dq)[:, :, :S, :D0], sk[:, :, :S, :D0],
            sv[:, :, :S, :D0])
