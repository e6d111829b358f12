"""The plain version of flash attention's backward
(``attention_bwd_ref``, the oracle of the backward kernel B6-bwd) against
JAX's gradients, on the CPU: ``jax.vjp`` of the reference's
``attention_ref`` (the Pallas kernel's oracle) and of the model's
``gqa_attention``, for the same q, k, v and output cotangent dO.

Cases: causal, a sliding window, not causal; GQA 1:1, 2:1, 4:1 and 16:1;
S = 1, S = 65 (not a multiple of a tile) and 128; D = 32, 64 and 256;
float32.  Tolerance: each gradient within ``2e-5`` of its largest
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

from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models.layers import gqa_attention as jax_gqa_attention
from repro_torch.kernels.flash_attention.ops import attention, attention_bwd
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref,
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
    """The backward's head-dim tile (32 / 64 / 128 / 256), no copy of the
    model's (B, S, H, D) transposed views, a copy of a tensor whose D is
    strided, and the refusal above 256 (ROADMAP Queue A)."""
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
    with pytest.raises(NotImplementedError, match="D > 256"):
        plan_attention_bwd(big, big, big, big, big)
