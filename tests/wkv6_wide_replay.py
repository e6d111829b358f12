"""A float32 torch replay of B7's two kernels above head dim 256
(``src/repro_torch/kernels/csrc/wkv6.cu``), written the way the kernels
are written, so the CPU tests can hold their schedule's arithmetic to the
JAX package.

``wide_chunk`` (T >= 16): a block holds 16 value columns of one (b, h)
for the whole sequence (the blocks are independent, so they are replayed
side by side); the channels are zero-padded to 128 NSL and taken in
slices of 128, one ring stage each; warp w of the 8 owns channels
16 w .. 16 w + 15 of every slice.  Per chunk of 16 rows and slice, each
warp on its channels: two lanes a channel form the log2-scaled prefix
one row at a time (rows 8..15 starting from the sum of rows 0..7), r~,
k~, exp2 of the chunk's total and their part of the bonus Σ r u k; the
warp adds r~ S (the old state) and r~ k~ᵀ into its own partials, then
updates its channels of the state, (S + k~ᵀ v) · decay.  After the
chunk's last slice the 8 warps' partials are added in warp order, the
bonus over the 16 lanes of each warp and then over the warps in order,
and y = Σ_w y_w + (tril_{-1}(A) + diag(bonus)) v.

``wide_step`` (T < 16, or D above ``WIDE_CHUNK_MAX``): the recurrence, a
warp per row group (rows g, g + 8, ...), each lane a value column; y_j is
the groups' sums added in group order (within a group torch's order, the
kernel's lane runs them one by one), then S_ij = w_i S_ij + k_i v_j.

The kernels' products run in 3xTF32 on the tensor cores and their
in-warp sums in the mma's order; the replay takes float32 products in
torch's order, so it holds the schedule (the splits, the padding, the
fixed-order sums, the prefix), not the bits.
"""

import torch

CHUNK = 16
LOG_W_MIN = -3.5
LOG2E = 1.4426950408889634
WARPS = 8
SLICE = 128
WIDE_CHUNK_MAX = 16 * SLICE


def slices_for(D: int) -> int:
    """NSL, the instantiation the launcher picks for head dim D."""
    for nsl in (3, 4, 8, 16):
        if D <= SLICE * nsl:
            return nsl
    raise ValueError(f"no wide_chunk build for D = {D}")


def _clamp(lw):
    return torch.clamp(lw, LOG_W_MIN, 0.0)


def wide_chunk(r, k, v, lw, u, s0=None):
    """(y, S) as ``wkv6_wide_chunk_kernel`` forms them; float32."""
    f32 = torch.float32
    B, H, T, D = r.shape
    nsl = slices_for(D)
    DP = SLICE * nsl
    nc = -(-T // CHUNK)
    TP = nc * CHUNK
    cols = -(-D // 16) * 16  # the column blocks' columns, past D zeros

    def pad(x, ch):
        x = x.to(f32)
        return torch.nn.functional.pad(x, (0, ch - x.shape[-1], 0, TP - T))

    rp, kp, lwp = (pad(x, DP) for x in (r, k, lw))
    vp = pad(v, cols)
    up = torch.nn.functional.pad(u.to(f32), (0, DP - D))
    S = torch.zeros((B, H, DP, cols), dtype=f32)
    if s0 is not None:
        S[:, :, :D, :D] = s0.to(f32)
    y = torch.zeros((B, H, TP, cols), dtype=f32)
    for c in range(nc):
        rows = slice(c * CHUNK, (c + 1) * CHUNK)
        vc = vp[:, :, rows]                                   # (B, H, 16, cols)
        yw = torch.zeros((WARPS, B, H, CHUNK, cols), dtype=f32)
        aw = torch.zeros((WARPS, B, H, CHUNK, CHUNK), dtype=f32)
        bp = torch.zeros((B, H, SLICE, CHUNK), dtype=f32)     # per thread
        for s in range(nsl):
            chs = slice(s * SLICE, (s + 1) * SLICE)
            l = _clamp(lwp[:, :, rows, chs]) * LOG2E
            rr, kk = rp[:, :, rows, chs], kp[:, :, rows, chs]
            uu = up[:, chs][None, :, None, :]
            rt = torch.empty_like(rr)
            kt = torch.empty_like(kk)
            # two lanes a channel: rows 0..7 from 0, rows 8..15 from the
            # lower rows' total, each a running sum row by row
            below = torch.zeros((B, H, SLICE), dtype=f32)
            for t in range(CHUNK // 2):
                below = below + l[:, :, t]
            cum = torch.zeros((B, H, SLICE), dtype=f32)
            for t in range(CHUNK):
                if t == CHUNK // 2:
                    cum = below
                cum = cum + l[:, :, t]
                prev = cum - l[:, :, t]
                bp[..., t] += rr[:, :, t] * uu[:, :, 0] * kk[:, :, t]
                rt[:, :, t] = rr[:, :, t] * torch.exp2(prev)
                kt[:, :, t] = kk[:, :, t] * torch.exp2(-cum)
            decay = torch.exp2(cum)                            # (B, H, 128)
            for w in range(WARPS):
                ch = slice(s * SLICE + 16 * w, s * SLICE + 16 * w + 16)
                lc = slice(16 * w, 16 * w + 16)
                yw[w] += rt[..., lc] @ S[:, :, ch]
                aw[w] += rt[..., lc] @ kt[..., lc].transpose(-1, -2)
                S[:, :, ch] = (S[:, :, ch] + kt[..., lc].transpose(-1, -2)
                               @ vc) * decay[..., lc, None]
        yc = yw[0].clone()
        A = aw[0].clone()
        for w in range(1, WARPS):
            yc += yw[w]
            A += aw[w]
        # the bonus: lanes 0..15 of warp w hold channels 16 w .. 16 w + 15
        # of each slice; warps in order
        bonus = bp[:, :, :16].sum(2)
        for w in range(1, WARPS):
            bonus = bonus + bp[:, :, 16 * w:16 * w + 16].sum(2)
        pos = torch.arange(CHUNK)
        A = torch.where(pos[None, :] < pos[:, None], A, 0.0)
        A = A + torch.diag_embed(bonus)
        y[:, :, rows] = yc + A @ vc
    return y[:, :, :T, :D], S[:, :, :D, :D].contiguous()


def wide_step(r, k, v, lw, u, s0=None):
    """(y, S) as ``wkv6_wide_step_kernel`` forms them; float32."""
    f32 = torch.float32
    B, H, T, D = r.shape
    S = (torch.zeros((B, H, D, D), dtype=f32) if s0 is None
         else s0.to(f32).clone())
    y = torch.zeros((B, H, T, D), dtype=f32)
    uf = u.to(f32)
    for t in range(T):
        l = _clamp(lw[:, :, t].to(f32))
        rr = r[:, :, t].to(f32) + (l - l)   # lw's NaN reaches y
        kk, vv = k[:, :, t].to(f32), v[:, :, t].to(f32)
        # a warp's rows g, g + 8, ...: each lane's running sum, then the
        # groups in order
        terms = rr[..., None] * ((uf[None] * kk)[..., None] * vv[:, :, None]
                                 + S)
        yt = terms[:, :, 0::WARPS].sum(2)
        for g in range(1, WARPS):
            yt = yt + terms[:, :, g::WARPS].sum(2)
        y[:, :, t] = yt
        S = torch.exp2(l * LOG2E)[..., None] * S + kk[..., None] * vv[:, :, None]
    return y, S


def replay(r, k, v, lw, u, s0=None):
    """The instantiation ``plan_wkv6`` picks at D > 256, replayed."""
    T, D = r.shape[2], r.shape[3]
    if T >= CHUNK and D <= WIDE_CHUNK_MAX:
        return wide_chunk(r, k, v, lw, u, s0)
    return wide_step(r, k, v, lw, u, s0)
