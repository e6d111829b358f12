"""The PyTorch port's flash attention (kernel B6's plain version and its
dispatcher) against the JAX package, on the CPU.

The same numpy inputs go to both packages.  Tolerances are the
reference's own (``tests/test_kernels.py``): ``atol = rtol = 2e-5`` in
float32 (scores and weights summed in another order) and ``3e-2`` in
bfloat16 (one bf16 rounding of the inputs and of the output).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.flash_attention.ops import attention as jax_attention
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch import kernels
from repro_torch.kernels.flash_attention.ops import (
    MAX_HEAD_DIM,
    SHORT_SEQ_MAX,
    attention,
    plan_attention,
)
from repro_torch.kernels.flash_attention.ref import (
    attention_lse_ref,
    attention_ref,
)
from repro_torch.obs import Telemetry, use_telemetry

import flash_wide_replay

# B, H, Hkv, S, D, causal, window: tests/test_kernels.py's six shapes,
# then the scorer's sequence and recurrentgemma-9b's head dim
FA_SHAPES = [
    (2, 4, 2, 256, 64, True, None),
    (1, 8, 8, 128, 128, True, 64),
    (2, 4, 1, 192, 80, False, None),   # partial blocks + MQA + D = 80
    (1, 2, 2, 100, 32, True, 32),      # odd seq
    (2, 16, 4, 128, 128, True, None),  # GQA 4:1
    (1, 4, 4, 384, 64, True, 128),     # window == block
] + [
    (2, 8, 8, 65, 64, True, None),     # the fraud scorer's 65 rows
    (1, 4, 1, 96, 256, True, 32),      # head dim 256, MQA, window
]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _inputs(B, H, Hkv, S, D, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(B, h, S, D)).astype(np.float32)
            for h in (H, Hkv, Hkv)]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window", FA_SHAPES)
def test_plain_version_and_dispatch_match_jax(B, H, Hkv, S, D, causal,
                                              window, dtype):
    jx, tx = _inputs(B, H, Hkv, S, D, dtype, B * 1000 + H * 10 + S + D)
    kw = dict(causal=causal, window=window)
    want = jax_attention_ref(*jx, **kw)
    kernels.reset_launches()
    tel = Telemetry()
    with use_telemetry(tel):
        got = attention(*tx, **kw)
    plain = attention_ref(*tx, **kw)
    assert got.dtype == tx[0].dtype and tuple(got.shape) == (B, H, S, D)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    np.testing.assert_array_equal(_np(got), _np(plain))
    c = tel.metrics.counter("kernel_dispatch_total", labels=("kernel", "impl"))
    assert c.value(kernel="flash_attention", impl="ref") == 1.0
    assert c.value(kernel="flash_attention", impl="cuda") == 0.0
    assert kernels.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("case", [
    (2, 4, 1, 192, 80, False, None),   # MQA, partial tiles, D = 80
    (1, 4, 4, 384, 64, True, 128),     # window
])
def test_plain_version_matches_pallas_interpret(case):
    B, H, Hkv, S, D, causal, window = case
    jx, tx = _inputs(B, H, Hkv, S, D, "float32", 31 + S)
    kw = dict(causal=causal, window=window)
    want = jax_attention(*jx, impl="pallas", interpret=True, **kw)
    np.testing.assert_allclose(_np(attention(*tx, **kw)), _np(want),
                               atol=2e-5, rtol=2e-5)


def test_scale_and_fully_masked_rows():
    """An explicit scale; a window that masks every key (``window=0``
    under the causal mask) gives zeros, as the reference's floor of the
    denominator does."""
    jx, tx = _inputs(1, 4, 2, 70, 32, "float32", 5)
    for kw in (dict(scale=0.3), dict(scale=0.3, causal=False, window=9),
               dict(window=0)):
        want = jax_attention_ref(*jx, **kw)
        np.testing.assert_allclose(_np(attention(*tx, **kw)), _np(want),
                                   atol=2e-5, rtol=2e-5)
    assert not attention(*tx, window=0).any()


def test_refusals():
    _, (q, k, v) = _inputs(1, 4, 2, 16, 8, "float32", 6)
    # CPU tensors under autograd: the plain version, differentiated (the
    # card's backward kernel and its D > 256 refusal are in
    # tests/test_torch_kernels_cuda.py)
    o = attention(q.requires_grad_(), k, v)
    o.sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape
    with torch.no_grad():
        attention(q, k, v)          # no graph: runs
    q = q.detach()
    with pytest.raises(ValueError, match="multiple of Hkv"):
        attention(q[:, :3], k, v)
    with pytest.raises(ValueError, match="do not fit"):
        attention(q, k[:, :, :8], v[:, :, :8])
    with pytest.raises(ValueError, match=r"\(B, H, S, D\)"):
        attention(q[0], k, v)


def _bf16_views(B, S, H, Hkv, hd):
    """The model's (B, S, H, hd) activations as (B, H, S, hd) views."""
    return [torch.zeros((B, S, h, hd), dtype=torch.bfloat16).transpose(1, 2)
            for h in (H, Hkv, Hkv)]


@pytest.mark.parametrize("hd", [64, 96, 128, 256])
def test_plan_takes_the_models_views_without_a_copy(hd):
    """``DecoderLM`` hands B6 transposed views of its projections: at every
    head dim of the registry's configs they need no copy, in both bf16
    instantiations and in float32."""
    for S, variant in ((SHORT_SEQ_MAX, "mma16"), (SHORT_SEQ_MAX + 1, "wgmma")):
        plan = plan_attention(*_bf16_views(2, S, 8, 2, hd))
        assert plan.variant == variant and plan.copy == (False,) * 3
        assert plan.head_dim == hd and plan.tile_d >= hd
    plan = plan_attention(*(x.float() for x in _bf16_views(2, 300, 8, 2, hd)))
    assert plan.variant == "f32" and plan.copy == (False,) * 3
    assert plan.head_dim == hd and plan.tile_d >= hd


def test_plan_instantiations_padding_grid_and_refusal():
    # the scorer's shape: a block per (b, KV head), a warp per 16-row tile
    plan = plan_attention(*_bf16_views(4096, 65, 8, 8, 64))
    assert (plan.variant, plan.tile_d, plan.grid, plan.threads) == (
        "mma16", 64, (4096 * 8, 1), 32 * 5)
    # GQA 6:1 at S = 128: 6 heads x 8 tiles share 8 warps
    assert plan_attention(*_bf16_views(1, 128, 48, 8, 128)).threads == 256
    # nemotron's prefill: 128-row query tiles, 3 warpgroups
    plan = plan_attention(*_bf16_views(8, 2048, 48, 8, 128))
    assert (plan.variant, plan.grid, plan.threads) == (
        "wgmma", (8 * 48, 16), 384)
    # D = 256: 64-row query tiles, 2 warpgroups
    plan = plan_attention(*_bf16_views(2, 4096, 16, 1, 256))
    assert (plan.tile_d, plan.grid, plan.threads) == (256, (32, 64), 256)
    # D = 100 is padded to 112 with zeros (all three copied)
    plan = plan_attention(*[torch.zeros(1, h, 300, 100, dtype=torch.bfloat16)
                            for h in (4, 2, 2)])
    assert plan.head_dim == 112 and plan.copy == (True,) * 3
    # a row stride TMA cannot take (100 elements = 200 bytes): copied
    base = torch.zeros(1, 4, 300, 100, dtype=torch.bfloat16)
    plan = plan_attention(base[..., :64], base[..., :64], base[..., :64])
    assert plan.head_dim == 64 and plan.copy == (True,) * 3
    # float32 ("f32", 3xTF32 on the tensor cores): 128-row tiles of 8
    # warps up to a head-dim tile of 128, 64 rows of 4 warp pairs above;
    # 32 rows of 2 warps for sequences up to F32_SHORT_S at tiles <= 64
    x = torch.zeros(2, 4, 300, 100)
    assert plan_attention(x, x, x) == plan_attention(x, x, x)
    plan = plan_attention(x, x, x)
    assert (plan.variant, plan.tile_d, plan.head_dim, plan.copy, plan.grid,
            plan.threads) == ("f32", 128, 100, (False,) * 3, (8, 3), 256)
    x = torch.zeros(2, 4, 300, 160)
    plan = plan_attention(x, x, x)
    assert (plan.tile_d, plan.grid, plan.threads) == (160, (8, 5), 256)
    # the scorer's 65 rows: three 32-row tiles a head
    plan = plan_attention(*[torch.zeros(4096, 8, 65, 64)] * 3)
    assert (plan.tile_d, plan.grid, plan.threads) == (64, (4096 * 8, 3), 64)
    assert plan_attention(*[torch.zeros(1, 2, 97, 64)] * 3).grid == (2, 1)
    # D = 33 is padded to 36 (copied); a row stride that is not a whole
    # 16-byte group (66 floats) is copied, a transposed view is not
    x = torch.zeros(1, 2, 100, 33)
    plan = plan_attention(x, x, x)
    assert (plan.tile_d, plan.head_dim, plan.copy) == (64, 36, (True,) * 3)
    base = torch.zeros(1, 2, 100, 66)
    plan = plan_attention(base[..., :64], base[..., :64], base[..., :64])
    assert (plan.head_dim, plan.copy) == (64, (True,) * 3)
    x = torch.zeros(2, 100, 4, 64).transpose(1, 2)
    assert plan_attention(x, x, x).copy == (False,) * 3
    # above MAX_HEAD_DIM: "wide"; bf16 a 64-row query tile and 512 output
    # columns a block (3 warpgroups), float32 32 rows and all 512 / 1,024
    # columns a block (256 threads); D as it is
    for dt, want in ((torch.bfloat16, ("wide", 512, 288, (False,) * 3,
                                       (2 * 1, 1), 384)),
                     (torch.float32, ("wide", 512, 288, (False,) * 3,
                                      (2 * 1, 2), 256))):
        plan = plan_attention(*[torch.zeros(1, 2, 40, MAX_HEAD_DIM + 32,
                                            dtype=dt)] * 3)
        assert (plan.variant, plan.tile_d, plan.head_dim, plan.copy,
                plan.grid, plan.threads) == want
    # wider heads take column passes: bf16 1,000 = 2 x 512 columns, float32
    # 1,000 in one pass of 1,024 and 1,500 in two
    x = torch.zeros(1, 2, 130, 1000, dtype=torch.bfloat16)
    assert plan_attention(x, x, x).grid == (2 * 2, 3)
    x = torch.zeros(1, 2, 130, 1000)
    assert (plan_attention(x, x, x).tile_d, plan_attention(x, x, x).grid) == (
        1024, (2, 5))
    x = torch.zeros(1, 2, 130, 1500)
    assert plan_attention(x, x, x).grid == (2 * 2, 5)
    # bf16 pads D to a multiple of 8 (copied), and copies a view TMA
    # cannot take
    x = torch.zeros(1, 2, 70, 289, dtype=torch.bfloat16)
    plan = plan_attention(x, x, x)
    assert (plan.head_dim, plan.copy) == (296, (True,) * 3)
    base = torch.zeros(1, 2, 70, 300, dtype=torch.bfloat16)
    plan = plan_attention(base[..., :288], base[..., :288], base[..., :288])
    assert (plan.head_dim, plan.copy) == (288, (True,) * 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [288, 512])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 40),
                                           (False, 50)])
def test_wide_kernel_replay_matches_jax(D, causal, window, dtype):
    """Above head dim 256: the ``"wide"`` kernels' schedule
    (``tests/flash_wide_replay.py``: bf16's D split between two consumers
    and their partial scores summed, 64 x 64 tiles, P rounded to bf16,
    the output in 64-column boxes; float32's 128-column score slices over
    32 x 32 tiles) and ``attention_ref``, against JAX's ``impl="xla"`` --
    causal, windowed, not causal, GQA 2:1, 130 rows (a ragged last tile)."""
    jx, tx = _inputs(2, 4, 2, 130, D, dtype, D + 7)
    kw = dict(causal=causal, window=window)
    want = jax_attention(*jx, impl="xla", **kw)
    assert plan_attention(*tx).variant == "wide"
    tol = TOL[dtype]
    got = flash_wide_replay.replay(*tx, **kw)
    assert got.dtype == tx[0].dtype
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(attention_ref(*tx, **kw)), _np(want),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_and_copied_inputs_match_jax(dtype):
    """What ``attention`` copies on the card -- D = 100 padded with zeros
    (the scale still 1 / sqrt(100)), a view with a 200-byte row stride --
    computes the same function (the CPU path takes the tensors as they
    are)."""
    jx, tx = _inputs(1, 4, 2, 70, 100, dtype, 11)
    want = jax_attention_ref(*jx)
    got = attention(*(F.pad(x, (0, 12)) for x in tx),
                    scale=100 ** -0.5)[..., :100]
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype],
                               rtol=TOL[dtype])
    jx64 = [x[..., :64] for x in jx]
    got = attention(*(x[..., :64] for x in tx))
    np.testing.assert_allclose(_np(got), _np(jax_attention_ref(*jx64)),
                               atol=TOL[dtype], rtol=TOL[dtype])


# (B, H, Hkv, S, D, causal, window) of the float32 forward's replay: each
# tile shape -- 32 rows x 16 keys for the scorer's short sequences (D =
# 32), 128 rows over 64-key tiles (D = 80, tile 96) and over 32-key ones
# (D = 128), 64 rows with D split over two warps over 16-key tiles (D =
# 256) -- with grouped heads, MQA, windows, not causal, S = 1, 65, 100 and
# 129
F32_FWD_CASES = [
    (2, 4, 2, 65, 32, True, None),
    (1, 4, 1, 100, 80, True, 40),
    (1, 2, 2, 65, 80, False, 30),
    (1, 4, 2, 129, 128, True, None),
    (2, 4, 2, 1, 128, True, None),
    (1, 2, 1, 129, 256, True, 48),
]


@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window", F32_FWD_CASES)
def test_f32_kernel_replay_matches_jax(B, H, Hkv, S, D, causal, window):
    """Up to head dim 256 in float32: the ``"f32"`` kernel's schedule
    (``tests/flash_wide_replay.py`` ``f32_forward``: the plan's tiles,
    S = Q Kᵀ and O += P V in 3xTF32 -- every hi part truncated, as the
    kernel splits it, and rounded beside it -- above D = 128 each score
    two warps' partials over D's halves summed)
    against JAX's ``impl="xla"`` within the reference's 2e-5; its lse =
    m + ln l within 1e-6 relative (+ 1e-6) of ``attention_lse_ref``'s,
    +inf on the same rows; the replay's tiles are the plan's."""
    jx, tx = _inputs(B, H, Hkv, S, D, "float32", 3 * S + D + H)
    kw = dict(causal=causal, window=window)
    want = jax_attention(*jx, impl="xla", **kw)
    o_rounded, _ = flash_wide_replay.f32_forward(*tx, rounded=True, **kw)
    np.testing.assert_allclose(_np(o_rounded), _np(want), atol=2e-5,
                               rtol=2e-5)
    o, lse = flash_wide_replay.f32_forward(*tx, **kw)
    assert o.shape == (B, H, S, D) and lse.shape == (B, H, S)
    np.testing.assert_allclose(_np(o), _np(want), atol=2e-5, rtol=2e-5)
    _, want_lse = attention_lse_ref(*tx, **kw)
    assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
    fin = torch.isfinite(want_lse)
    assert bool(((lse[fin] - want_lse[fin]).abs()
                 <= 1e-6 * want_lse[fin].abs() + 1e-6).all())
    plan = plan_attention(*tx)
    tile, (rows, _, warps) = flash_wide_replay.f32_fwd_tiles(D, S)
    assert (plan.variant, plan.tile_d, plan.grid, plan.threads) == (
        "f32", tile, (B * H, -(-S // rows)), 32 * warps * rows // 16)
