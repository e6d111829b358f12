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

from repro.kernels.flash_attention.ops import attention as jax_attention
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch import kernels
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.obs import Telemetry, use_telemetry

# B, H, Hkv, S, D, causal, window: tests/test_kernels.py's six shapes
FA_SHAPES = [
    (2, 4, 2, 256, 64, True, None),
    (1, 8, 8, 128, 128, True, 64),
    (2, 4, 1, 192, 80, False, None),   # partial blocks + MQA + D = 80
    (1, 2, 2, 100, 32, True, 32),      # odd seq
    (2, 16, 4, 128, 128, True, None),  # GQA 4:1
    (1, 4, 4, 384, 64, True, 128),     # window == block
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
