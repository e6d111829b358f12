"""The plain version of flash attention's backward
(``attention_bwd_ref``, the oracle of the backward kernel B6-bwd) against
JAX's gradients, on the CPU: ``jax.vjp`` of the reference's
``attention_ref`` (the Pallas kernel's oracle) and of the model's
``gqa_attention``, for the same q, k, v and output cotangent dO.

Cases: causal, a sliding window, not causal; GQA 1:1, 2:1, 4:1 and 16:1;
S = 1, S = 65 (not a multiple of a tile) and 128; D = 32, 64, 256 and,
above the tiled kernels, 288 and 512; float32.  Tolerance: each gradient within ``2e-5`` of its largest
|value| plus ``1e-5`` (float32 products summed in other orders; at
S = 1 dQ and dK are zero in exact arithmetic and come out as the rounding
of dP - Δ, two sums of D unit-scale products, ~1e-6).  The dispatcher: on CPU
tensors ``attention`` is differentiated by autograd through the plain
forward, and ``attention_bwd`` equals that gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flash_wide_replay

from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models.layers import gqa_attention as jax_gqa_attention
from repro_torch.kernels.flash_attention.ops import attention, attention_bwd
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref,
    attention_lse_ref,
    attention_ref,
)

CASES = [  # B, H, Hkv, S, D, causal, window
    (2, 4, 4, 65, 64, True, None),
    (1, 8, 2, 128, 32, True, 48),
    (2, 4, 1, 65, 64, False, None),
    (1, 16, 1, 33, 32, True, None),
    (1, 8, 2, 1, 64, True, None),
    (1, 4, 1, 40, 256, True, 17),
    (2, 2, 2, 20, 256, False, 7),
    (1, 4, 2, 40, 288, True, None),
    (1, 4, 1, 33, 512, True, 9),
]


def _inputs(B, H, Hkv, S, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, S, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    do = rng.normal(size=(B, H, S, D)).astype(np.float32)
    return q, k, v, do


def _close(got, want):
    want = np.asarray(want)
    bound = 2e-5 * float(np.abs(want).max()) + 1e-5
    assert float(np.abs(got.numpy() - want).max()) <= bound


@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window", CASES)
def test_attention_bwd_ref_matches_jax_gradients(B, H, Hkv, S, D, causal,
                                                 window):
    q, k, v, do = _inputs(B, H, Hkv, S, D, S + D + H)
    kw = dict(causal=causal, window=window)
    o, vjp = jax.vjp(lambda a, b, c: jax_attention_ref(a, b, c, **kw),
                     q, k, v)
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    got = attention_bwd_ref(tq, tk, tv, torch.from_numpy(np.asarray(o)), tdo,
                            **kw)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.shape == x.shape and g.dtype == torch.float32
        _close(g, w)

    # the model's gqa_attention, (B, S, H, D) with positions
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    tr = lambda x: jnp.swapaxes(jnp.asarray(x), 1, 2)  # noqa: E731
    o2, vjp2 = jax.vjp(
        lambda a, b, c: jax_gqa_attention(a, b, c, pos, pos, **kw),
        tr(q), tr(k), tr(v))
    want2 = [np.swapaxes(np.asarray(g), 1, 2) for g in vjp2(tr(do))]
    o2 = torch.from_numpy(np.swapaxes(np.asarray(o2), 1, 2).copy())
    got2 = attention_bwd_ref(tq, tk, tv, o2, tdo, **kw)
    for g, w in zip(got2, want2):
        _close(g, w)


def test_cpu_attention_is_differentiated_through_the_plain_forward():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2, 6, 2, 37, 32, 9))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = attention(*leaves, window=11, scale=0.3)
    assert torch.equal(o.detach(), attention_ref(q, k, v, window=11, scale=0.3))
    o.backward(do)
    got = attention_bwd(q, k, v, o.detach(), do, window=11, scale=0.3)
    for g, leaf in zip(got, leaves):
        _close(g, leaf.grad.numpy())
    with pytest.raises(ValueError, match="q's shape"):
        attention_bwd(q, k, v, o.detach()[:, :, 1:], do)


def test_plan_attention_bwd_tiles_copies_and_refusal():
    """The float32 backward's head-dim tile (32 / 64 / 128 / 256), no copy
    of the model's (B, S, H, D) transposed views, a copy of a tensor whose
    D is strided, and above 256 the ``"wide"`` 3xTF32 kernels (512 output
    columns a block: Δ, wide dQ, wide dK / dV, no group sum at G = 1)
    where the plan once refused."""
    from repro_torch.kernels.flash_attention.ops import plan_attention_bwd

    for D, tile in ((8, 32), (32, 32), (48, 64), (64, 64), (96, 128),
                    (128, 128), (200, 256), (256, 256)):
        x = torch.zeros((2, 9, 4, D)).transpose(1, 2)
        plan = plan_attention_bwd(x, x, x, x, x)
        assert plan.tile_d == tile and not any(plan.copy)
    y = torch.zeros((2, 4, 9, 128))[..., ::2]
    x = torch.zeros((2, 4, 9, 64))
    assert plan_attention_bwd(x, x, x, x, y).copy == (False,) * 4 + (True,)
    big = torch.zeros((1, 2, 4, 288))
    plan = plan_attention_bwd(big, big, big, big, big)
    assert (plan.variant, plan.tile_d, plan.head_dim, plan.rows, plan.copy,
            plan.reduce, plan.launches) == (
        "wide", 512, 288, (32, 32), (False,) * 5, False,
        ("f32_delta", "f32_wide_dq", "f32_wide_dkdv"))


# chip_smoke.py's FA_BWD_SHAPES, the training paths' shapes (B, H, Hkv, S,
# D): the scorer, seamless-m4t-medium's decoder and encoder, nemotron's
# GQA, a 2,048 window, recurrentgemma's MQA at D = 256; and phi3's D = 96
PLAN_SHAPES = [
    (256, 8, 8, 72, 64), (2, 16, 16, 1024, 64), (1, 48, 8, 2048, 128),
    (1, 32, 8, 4096, 128), (1, 16, 1, 4096, 256), (8, 32, 32, 1024, 96),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,Hkv,S,D", PLAN_SHAPES)
def test_plan_attention_bwd_variant_padding_reduce_and_scratch(B, H, Hkv, S,
                                                               D, dtype):
    """bf16 plans ``wgmma`` (D padded to a multiple of 16, its tile 64 /
    128 / 256: D = 96 on 128), float32 ``f32`` (its tile 32 / 64 / 128 /
    256: D = 96 on 128); each the Δ pre-pass, dQ, dK / dV and, only for
    H > Hkv, the group sum, whose float32 partials (2·B·H·S·D) are the
    scratch beside Δ (float32: each kernel's own Δ, two planes).  Shapes
    only: the tensors are on the meta device."""
    from repro_torch.kernels.flash_attention.ops import plan_attention_bwd

    q = torch.empty((B, H, S, D), dtype=dtype, device="meta")
    kv = torch.empty((B, Hkv, S, D), dtype=dtype, device="meta")
    plan = plan_attention_bwd(q, kv, kv, q, q)
    assert not any(plan.copy)
    tile = {64: 64, 96: 128, 128: 128, 256: 256}[D]
    assert plan.reduce == (H > Hkv)
    f32 = dtype == torch.float32
    assert plan.scratch_bytes == 4 * B * H * S * (
        1 + f32 + (2 * D if H > Hkv else 0))
    if f32:
        assert (plan.variant, plan.tile_d, plan.head_dim) == ("f32", tile, D)
        # the scorer's S = 72 takes the short sequences' 32-row tiles
        assert plan.rows == ((32, 32) if S <= 96 else {
            64: (64, 64), 128: (128, 128), 256: (64, 32)}[tile])
        assert plan.launches == ("f32_delta", "f32_dq", "f32_dkdv") + (
            ("f32_reduce",) if H > Hkv else ())
        return
    assert (plan.variant, plan.tile_d, plan.head_dim) == ("wgmma", tile, D)
    assert plan.rows == ((128, 128) if tile <= 128 else (64, 64))
    assert plan.launches == ("delta", "dq", "dkdv") + (
        ("reduce",) if H > Hkv else ())


def test_plan_attention_bwd_f32_pads_and_copies():
    """float32: D = 33 pads to 36 (every tensor copied) on the 64 tile, a
    stride that is not a whole number of 16-byte groups (D = 66 of 68) or a
    base off 16 bytes is copied, the model's views are not; grouped heads
    add the group sum above 256 too, its partials at the padded D."""
    from repro_torch.kernels.flash_attention.ops import plan_attention_bwd

    x = torch.zeros((2, 9, 4, 33)).transpose(1, 2)
    plan = plan_attention_bwd(x, x, x, x, x)
    assert (plan.variant, plan.head_dim, plan.tile_d, plan.copy) == (
        "f32", 36, 64, (True,) * 5)
    x = torch.zeros((2, 9, 4, 64)).transpose(1, 2)
    assert not any(plan_attention_bwd(x, x, x, x, x).copy)
    odd = torch.zeros((2, 4, 9, 68))[..., :66]
    shifted = torch.zeros(2 * 4 * 9 * 64 + 1)[1:].view(2, 4, 9, 64)
    y = torch.zeros((2, 4, 9, 64))
    assert plan_attention_bwd(y, y, y, shifted, y).copy == (
        (False,) * 3 + (True, False))
    assert plan_attention_bwd(odd, odd, odd, odd, odd).head_dim == 68
    q = torch.empty((1, 8, 4, 300), device="meta")
    kv = torch.empty((1, 2, 4, 300), device="meta")
    plan = plan_attention_bwd(q, kv, kv, q, q)
    assert (plan.variant, plan.head_dim, plan.copy, plan.reduce) == (
        "wide", 300, (False,) * 5, True)
    assert plan.launches == ("f32_delta", "f32_wide_dq", "f32_wide_dkdv",
                             "f32_reduce")
    assert plan.scratch_bytes == 4 * 8 * 4 * (2 + 2 * 300)


def test_plan_attention_bwd_bf16_pads_and_copies():
    """bf16: D = 40 pads to 48 (every tensor copied), a D-strided tensor
    or a 16-byte-unaligned stride is copied, the model's (B, S, H, D)
    views are not; above 256 the ``"wide"`` tensor-core kernels (D padded
    to a multiple of 8, the group sum with grouped heads) where the plan
    once refused."""
    from repro_torch.kernels.flash_attention.ops import plan_attention_bwd

    bf = dict(dtype=torch.bfloat16, device="meta")
    x = torch.empty((2, 9, 4, 40), **bf).transpose(1, 2)
    plan = plan_attention_bwd(x, x, x, x, x)
    assert (plan.head_dim, plan.tile_d, plan.copy) == (48, 64, (True,) * 5)
    x = torch.empty((2, 9, 4, 64), **bf).transpose(1, 2)
    assert not any(plan_attention_bwd(x, x, x, x, x).copy)
    y = torch.empty((2, 4, 9, 128), **bf)[..., ::2]
    odd = torch.empty((2, 4, 9, 68), **bf)[..., :64]
    assert plan_attention_bwd(x, x, x, y, odd).copy == (False,) * 3 + (True,) * 2
    big = torch.empty((1, 2, 4, 288), **bf)
    plan = plan_attention_bwd(big, big, big, big, big)
    assert (plan.variant, plan.tile_d, plan.head_dim, plan.rows, plan.copy,
            plan.reduce, plan.launches) == (
        "wide", 512, 288, (64, 64), (False,) * 5, False,
        ("delta", "wide_dq", "wide_dkdv"))
    q = torch.empty((1, 8, 4, 300), **bf)
    kv = torch.empty((1, 2, 4, 300), **bf)
    plan = plan_attention_bwd(q, kv, kv, q, q)
    assert (plan.head_dim, plan.copy, plan.reduce) == (304, (True,) * 5, True)
    assert plan.launches == ("delta", "wide_dq", "wide_dkdv", "reduce")
    assert plan.scratch_bytes == 4 * 8 * 4 * (1 + 2 * 304)


LSE_CASES = [  # B, H, Hkv, S, D, causal, window
    (2, 4, 2, 65, 64, True, None),
    (1, 6, 3, 40, 32, False, 9),
    (1, 4, 1, 33, 256, True, 17),
    (1, 2, 2, 12, 64, True, -2),  # no row sees a key: lse = +inf
]


@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window", LSE_CASES)
def test_attention_lse_ref_matches_float64_logsumexp(B, H, Hkv, S, D, causal,
                                                     window):
    """``attention_lse_ref``'s lse equals a float64 numpy log-sum-exp of the
    same scaled scores over the visible keys within 1e-6 relative (+ 1e-6
    absolute, for a row whose lse is near 0), +inf on a row that sees no
    key; its o is ``attention_ref``'s, bit for bit."""
    q, k, v, _ = _inputs(B, H, Hkv, S, D, S * D + H)
    kw = dict(causal=causal, window=window)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = attention_lse_ref(tq, tk, tv, **kw)
    assert torch.equal(o, attention_ref(tq, tk, tv, **kw))
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    kk = np.repeat(k.astype(np.float64), H // Hkv, axis=1)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), kk) / np.sqrt(D)
    pos = np.arange(S)
    vis = np.ones((S, S), bool)
    if causal:
        vis &= pos[None, :] <= pos[:, None]
    if window is not None:
        vis &= pos[None, :] > pos[:, None] - window
    s = np.where(vis, s, -np.inf)
    m = s.max(-1, keepdims=True)
    with np.errstate(invalid="ignore"):
        want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    want = np.where(vis.any(-1), want, np.inf)
    got = lse.numpy().astype(np.float64)
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert np.all(np.abs(got[fin] - want[fin])
                  <= 1e-6 * np.abs(want[fin]) + 1e-6)


@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window", LSE_CASES)
def test_attention_bwd_ref_given_lse_equals_its_recomputation(
        B, H, Hkv, S, D, causal, window):
    """``attention_bwd_ref`` taking P = exp(scale·s − lse) from the
    forward's lse equals its own softmax recomputation (float32, the
    module's tolerance); ``attention_with_lse`` and ``attention_bwd`` on
    CPU tensors are the plain versions."""
    from repro_torch.kernels.flash_attention.ops import attention_with_lse

    q, k, v, do = (torch.from_numpy(x)
                   for x in _inputs(B, H, Hkv, S, D, S + 3 * D))
    kw = dict(causal=causal, window=window)
    o, lse = attention_with_lse(q, k, v, **kw)
    want_o, want_lse = attention_lse_ref(q, k, v, **kw)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    got = attention_bwd_ref(q, k, v, o, do, lse=lse, **kw)
    want = attention_bwd_ref(q, k, v, o, do, **kw)
    for g, w in zip(got, want):
        _close(g, w.numpy())
    for g, w in zip(attention_bwd(q, k, v, o, do, lse=lse, **kw), got):
        assert torch.equal(g, w)


# (B, H, Hkv, S, D, causal, window): one column pass of each at D = 288;
# two of dQ and three of dK / dV (bf16), two of each (float32) at D = 600
WIDE_BWD_CASES = [
    (1, 4, 2, 70, 288, True, None),
    (1, 2, 1, 40, 600, True, 9),
    (1, 2, 2, 33, 288, False, 20),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window", WIDE_BWD_CASES)
def test_wide_bwd_replay_matches_bwd_ref(B, H, Hkv, S, D, causal, window,
                                         dtype):
    """Above head dim 256: the ``"wide"`` backward kernels' schedule
    (``tests/flash_wide_replay.py``: bf16's score products split over D's
    boxes between two consumers and their partials summed, P from the
    forward's lse, P and dS rounded to bf16, dQ in 512-column passes and
    dK / dV in 256-column ones, each forming its scores again, the group
    summed in head order; float32's 64-column score slices, row
    chunks of 256 / 128 columns split over four warps, 3xTF32 products,
    P from the float32 forward's lse, 512-column passes) against
    ``attention_bwd_ref`` -- bf16 within the forward's bf16 tolerance
    3e-2, float32 within the module's."""
    q, k, v, do = (torch.from_numpy(x)
                   for x in _inputs(B, H, Hkv, S, D, S + D + H))
    kw = dict(causal=causal, window=window)
    if dtype == torch.bfloat16:
        q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
        o, lse = attention_lse_ref(q, k, v, **kw)
        got = flash_wide_replay.wide_bwd_bf16(q, k, v, o, do, lse, **kw)
        want = attention_bwd_ref(q, k, v, o, do, **kw)
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16
            np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                       atol=3e-2, rtol=3e-2)
        return
    o, lse = flash_wide_replay.f32_forward(q, k, v, **kw)
    got = flash_wide_replay.f32_bwd(q, k, v, o, do, lse, **kw)
    for g, w in zip(got, attention_bwd_ref(q, k, v, o, do, **kw)):
        _close(g, w.numpy())


# (B, H, Hkv, S, D, causal, window) of the float32 backward's replay: each
# head-dim tile (D = 32, 64, 128, 256; 33 padded to 36) and "wide" (288,
# 512), grouped heads, windows, S = 1 and S off the tiles' multiples
F32_BWD_CASES = [
    (1, 8, 2, 128, 32, True, 48),
    (2, 4, 1, 65, 64, False, None),
    (1, 8, 2, 1, 64, True, None),
    (1, 4, 2, 130, 128, True, None),
    (1, 4, 1, 40, 256, True, 17),
    (1, 3, 1, 70, 33, True, None),
    (1, 4, 2, 40, 288, True, None),
    (1, 4, 1, 33, 512, True, 9),
]
# B6-bwd's float32 bound against the plain version (chip_smoke.py's
# FA_BWD_F32_REL): each gradient within this share of its largest |value|
# (+ 1e-6)
FA_BWD_F32_REL = 1e-4


@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window", F32_BWD_CASES)
def test_f32_bwd_replay_matches_jax_gradients(B, H, Hkv, S, D, causal,
                                              window):
    """The float32 backward kernels' schedule (``tests/flash_wide_replay.py``
    ``f32_bwd``: the plan's tiles, 3xTF32 products emulated on the int32
    bits, each score contracted by its row group's warps and their
    partials summed in warp order, P from the float32 forward's lse, the
    group's per-head partials summed in head order) against ``jax.vjp`` of
    the reference's ``attention_ref``, within ``FA_BWD_F32_REL``; the
    replay's tiles are the plan's."""
    from repro_torch.kernels.flash_attention.ops import plan_attention_bwd

    q, k, v, do = _inputs(B, H, Hkv, S, D, S + D + H)
    kw = dict(causal=causal, window=window)
    _, vjp = jax.vjp(lambda a, b, c: jax_attention_ref(a, b, c, **kw),
                     q, k, v)
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = flash_wide_replay.f32_forward(tq, tk, tv, **kw)
    got = flash_wide_replay.f32_bwd(tq, tk, tv, o, tdo, lse, **kw)
    for g, w, x in zip(got, want, (q, k, v)):
        w = np.asarray(w)
        assert g.shape == x.shape
        assert float(np.abs(g.numpy() - w).max()) <= (
            FA_BWD_F32_REL * float(np.abs(w).max()) + 1e-6)
    plan = plan_attention_bwd(*(torch.empty(x.shape, device="meta")
                                for x in (tq, tk, tv, tq, tq)))
    tile = flash_wide_replay.f32_tile(D)
    (bmq, *_), (bmk, *_) = flash_wide_replay.f32_tiles(D, S)
    assert (plan.tile_d, plan.rows, plan.reduce) == (tile, (bmq, bmk),
                                                     H > Hkv)


@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window", LSE_CASES + [
    (1, 4, 2, 40, 288, True, None)])
def test_f32_attention_with_lse_is_attention_lse_ref(B, H, Hkv, S, D, causal,
                                                    window):
    """float32 ``attention_with_lse`` returns ``attention_lse_ref``'s o and
    lse on CPU tensors, and the float32 forward kernels' lse -- m + ln l of
    their online softmax (``flash_wide_replay.f32_forward``) -- is within
    1e-6 relative (+ 1e-6) of it, +inf on the same rows, with o within
    the forward's 2e-5."""
    from repro_torch.kernels.flash_attention.ops import attention_with_lse

    q, k, v, _ = (torch.from_numpy(x)
                  for x in _inputs(B, H, Hkv, S, D, 5 * S + D))
    kw = dict(causal=causal, window=window)
    o, lse = attention_with_lse(q, k, v, **kw)
    want_o, want = attention_lse_ref(q, k, v, **kw)
    assert torch.equal(o, want_o) and torch.equal(lse, want)
    ro, rl = flash_wide_replay.f32_forward(q, k, v, **kw)
    assert torch.equal(torch.isinf(rl), torch.isinf(want))
    fin = torch.isfinite(want)
    assert bool(((rl[fin] - want[fin]).abs()
                 <= 1e-6 * want[fin].abs() + 1e-6).all())
    torch.testing.assert_close(ro, want_o, atol=2e-5, rtol=2e-5)
