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
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.obs import Telemetry, use_telemetry

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
    with pytest.raises(NotImplementedError, match="no backward"):
        attention(q.requires_grad_(), k, v)
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
    assert plan.variant == "simt" and plan.copy == (False,) * 3


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
    # float32 takes any D on the CUDA cores: 64-row tiles, 32 above D 128
    x = torch.zeros(2, 4, 300, 100)
    assert plan_attention(x, x, x) == plan_attention(x, x, x)
    plan = plan_attention(x, x, x)
    assert (plan.variant, plan.tile_d, plan.head_dim, plan.grid) == (
        "simt", 128, 100, (8, 5))
    x = torch.zeros(2, 4, 300, 160)
    assert plan_attention(x, x, x).grid == (8, 10)
    # above MAX_HEAD_DIM, either dtype: "wide", 256 output columns and 32
    # query rows a block, D as it is
    for dt in (torch.bfloat16, torch.float32):
        plan = plan_attention(*[torch.zeros(1, 2, 40, MAX_HEAD_DIM + 32,
                                            dtype=dt)] * 3)
        assert (plan.variant, plan.tile_d, plan.head_dim, plan.copy,
                plan.grid, plan.threads) == (
            "wide", 256, 288, (False,) * 3, (2 * 2, 2), 128)


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
