"""The PyTorch port's signature ids and signature embedding against the JAX
package, on the CPU (the port runs its kernel's plain version there).

Tolerances:

* ``signature_ids`` and ``multi_hash_ids``: bit-exact (int32).
* ``signature_embed`` on a float32 table: bit-exact for one probe.  For
  k > 1 the JAX package on the CPU — ``impl="xla"`` and
  ``impl="pallas", interpret=True`` alike — contracts each
  ``out + w_j * x_j`` into a fused multiply-add, where the port (and its
  CUDA kernel, like the Pallas body) rounds the product first; so each
  element is held within ``1e-6`` relative to the magnitude of its terms,
  ``sum_j |w_j| * |x_j|`` (the FMA moves each probe by at most half an
  ulp of its product).
* ``signature_embed`` on a bfloat16 table, against the Pallas path
  (``interpret=True``), which keeps the weights in float32 as the port
  does: bit-exact for one probe; for k > 1 the float32 sums before the
  cast are held as above, and the bf16 results within one bf16 rounding
  of the magnitude (``2**-8 * sum_j |w_j| * |x_j|``), where the two sums
  straddle a rounding boundary (1 element of 8,448 at k = 4; the rest
  bit-exact, and the test asks for 99 %).  The JAX einsum oracle
  (``impl="xla"``) rounds the weights to bfloat16 first and differs by
  up to a few bf16 ulps for weights that bf16 cannot hold; the port's own
  copy of that oracle (``hash_embedding_lookup_ref``) matches it bit for
  bit on these inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.signature import hash_embedding_lookup_ref as jax_lookup_ref
from repro.core.signature import multi_hash_ids as jax_multi_hash_ids
from repro.core.signature import signature_ids as jax_signature_ids
from repro.kernels.signature.ops import signature_embed as jax_signature_embed
from repro.kernels.signature.signature import (
    signature_embed_pallas as jax_signature_embed_pallas,
)
from repro_torch import kernels
from repro_torch.core.signature import (
    hash_embedding_lookup_ref,
    multi_hash_ids,
    signature_ids,
)
from repro_torch.kernels.signature.ops import signature_embed
from repro_torch.kernels.signature.ref import signature_embed_ref
from repro_torch.obs import Telemetry, use_telemetry

# tests/test_kernels.py's shapes: (V, D, N, k)
SIG_SHAPES = [(512, 128, 64, 2), (1024, 256, 33, 4), (256, 64, 7, 1)]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("bits", [16, 20, 24])
@pytest.mark.parametrize("ncols", [1, 2, 3])
def test_signature_ids_bit_exact(ncols, bits):
    rng = np.random.default_rng(ncols * 100 + bits)
    cols = [rng.integers(-2**31, 2**31 - 1, 2000).astype(np.int32)
            for _ in range(ncols)]
    cols[0][:4] = [0, -1, 2**31 - 1, -2**31]
    if ncols > 1:  # a float32 column hashes its bit pattern
        cols[1] = rng.normal(size=2000).astype(np.float32)
    want = jax_signature_ids([jnp.asarray(c) for c in cols], bits=bits)
    got = signature_ids([torch.as_tensor(c) for c in cols], bits=bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.min() >= 0 and got.max() < 2 ** bits


@pytest.mark.parametrize("table_size", [1000, 4096, 12_345])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_multi_hash_ids_bit_exact(k, table_size):
    rng = np.random.default_rng(k * table_size)
    sig = rng.integers(0, 2**20, 3000).astype(np.int32)
    want = jax_multi_hash_ids(jnp.asarray(sig), k, table_size)
    got = multi_hash_ids(torch.as_tensor(sig), k, table_size)
    assert got.shape == (3000, k) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _inputs(V, D, N, k, seed=0):
    rng = np.random.default_rng(seed + V + D + N + k)
    table = rng.normal(size=(V, D)).astype(np.float32)
    sig = rng.integers(0, 2**20, N).astype(np.int32)
    w = rng.normal(size=(k,)).astype(np.float32)
    return table, sig, w


def _jax_embed(table, sig, w, k, impl):
    return jax_signature_embed(
        table, jnp.asarray(sig), jnp.asarray(w), num_hashes=k, impl=impl,
        interpret=impl == "pallas",
    )


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("V,D,N,k", SIG_SHAPES)
def test_signature_embed_f32_matches_jax(V, D, N, k, impl):
    table, sig, w = _inputs(V, D, N, k)
    want = np.asarray(_jax_embed(jnp.asarray(table), sig, w, k, impl))
    got = signature_embed(torch.as_tensor(table), torch.as_tensor(sig),
                          torch.as_tensor(w), num_hashes=k)
    assert got.dtype == torch.float32 and got.shape == (N, D)
    got = got.numpy()
    if k == 1:
        np.testing.assert_array_equal(_bits(got), _bits(want))
        return
    ids = multi_hash_ids(torch.as_tensor(sig), k, V).numpy()
    mag = sum(np.abs(w[j]) * np.abs(table[ids[:, j]]) for j in range(k))
    assert np.all(np.abs(got - want) <= 1e-6 * mag), (
        f"max |diff| / magnitude {np.max(np.abs(got - want) / mag)}"
    )


@pytest.mark.parametrize("V,D,N,k", SIG_SHAPES)
def test_signature_embed_bf16_matches_pallas(V, D, N, k):
    table, sig, w = _inputs(V, D, N, k, seed=1)
    jt = jnp.asarray(table).astype(jnp.bfloat16)
    tt = torch.as_tensor(table).to(torch.bfloat16)
    ids = multi_hash_ids(torch.as_tensor(sig), k, V)
    # the float32 sums before the cast: the Pallas body against the plain
    # version, on the same ids
    want32 = np.asarray(jax_signature_embed_pallas(
        jt, jnp.asarray(ids.numpy()), jnp.asarray(w), interpret=True))
    got32 = signature_embed_ref(tt, ids, torch.as_tensor(w)).numpy()
    want = np.asarray(_jax_embed(jt, sig, w, k, "pallas")).astype(np.float32)
    got = signature_embed(tt, torch.as_tensor(sig), torch.as_tensor(w),
                          num_hashes=k)
    assert got.dtype == torch.bfloat16
    got = got.to(torch.float32).numpy()
    if k == 1:
        np.testing.assert_array_equal(_bits(got32), _bits(want32))
        np.testing.assert_array_equal(_bits(got), _bits(want))
        return
    tf = tt.to(torch.float32).numpy()
    mag = sum(np.abs(w[j]) * np.abs(tf[ids[:, j].numpy()]) for j in range(k))
    assert np.all(np.abs(got32 - want32) <= 1e-6 * mag)
    # one bf16 rounding of sums that differ in their last float32 bits
    assert np.all(np.abs(got - want) <= 2.0**-8 * mag)
    assert np.mean(_bits(got) == _bits(want)) > 0.99


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("V,D,N,k", SIG_SHAPES)
def test_hash_embedding_lookup_ref_matches_jax(V, D, N, k, dtype):
    table, sig, w = _inputs(V, D, N, k, seed=2)
    jt = jnp.asarray(table).astype(dtype)
    want = np.asarray(jax_lookup_ref(jt, jnp.asarray(sig), jnp.asarray(w), k))
    tt = torch.as_tensor(table).to(getattr(torch, dtype))
    got = hash_embedding_lookup_ref(tt, torch.as_tensor(sig),
                                    torch.as_tensor(w), k)
    assert got.dtype == tt.dtype
    got = got.to(torch.float32).numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_bits(got), _bits(want.astype(np.float32)))
    else:
        ids = multi_hash_ids(torch.as_tensor(sig), k, V).numpy()
        mag = sum(np.abs(w[j]) * np.abs(table[ids[:, j]]) for j in range(k))
        assert np.all(np.abs(got - want) <= 1e-6 * mag)


def test_plain_version_adds_probes_in_order_without_fma():
    """Cases where rounding the product first and a fused multiply-add
    give different results: the plain version rounds first, in probe
    order, starting from +0.0."""
    table = torch.tensor([[1.0 + 2.0**-23], [-1.0], [-0.0]], dtype=torch.float32)
    ids = torch.tensor([[0, 1], [2, 2]], dtype=torch.int32)
    w = torch.tensor([1.0 + 2.0**-23, 1.0], dtype=torch.float32)
    out = signature_embed_ref(table, ids, w)
    # (1 + 2^-23)^2 rounds to 1 + 2^-22; minus 1 is exactly 2^-22 (an FMA
    # would keep the 2^-46 term)
    assert out[0, 0].item() == 2.0**-22
    # 0.0 + (-0.0) * w is +0.0
    assert out[1, 0].item() == 0.0 and not torch.signbit(out[1, 0])


def test_cpu_dispatch_counts_no_launch():
    table, sig, w = _inputs(64, 16, 10, 2)
    kernels.reset_launches()
    tel = Telemetry()
    with use_telemetry(tel):
        signature_embed(torch.as_tensor(table), torch.as_tensor(sig),
                        torch.as_tensor(w), num_hashes=2)
    assert kernels.LAUNCHES["signature_embed"] == 0
    c = tel.metrics.counter("kernel_dispatch_total", labels=("kernel", "impl"))
    assert c.value(kernel="signature_embed", impl="ref") == 1.0
    with pytest.raises(ValueError, match="weights"):
        signature_embed(torch.as_tensor(table), torch.as_tensor(sig),
                        torch.as_tensor(w), num_hashes=3)


# -- the kernel's id hashing, replayed in numpy as signature_embed.cu
# writes it: multiplies on uint32, shifts arithmetic on int32, abs on uint32


def _mix32_kernel(x, salt):
    h = np.asarray(x, np.int32) ^ np.int32(salt & 0x7FFFFFFF)
    h = h ^ (h >> 16)
    h = (h.view(np.uint32) * np.uint32(0x85EBCA6B)).view(np.int32)
    h = h ^ ((h >> 13) & np.int32(0x0007FFFF))
    h = (h.view(np.uint32) * np.uint32(0xC2B2AE35)).view(np.int32)
    return h ^ ((h >> 16) & np.int32(0x0000FFFF))


def _abs31_kernel(h):
    """``(h < 0 ? 0u - (uint32)h : (uint32)h) & 0x7FFFFFFF``."""
    u = np.asarray(h, np.int32).view(np.uint32)
    neg = np.asarray(h, np.int32) < 0
    a = np.where(neg, np.uint32(0) - u, u)
    return (a & np.uint32(0x7FFFFFFF)).astype(np.int64)


def _probe_id_kernel(sig, j, V):
    salt = (0x85EB * (j + 1) + 17) & 0xFFFFFFFF
    h1 = _mix32_kernel(sig, salt)
    h2 = _mix32_kernel(h1 ^ np.int32(0x5BD1E995), salt ^ 0x27D4EB2F)
    t = (h2.view(np.uint32) * np.uint32(5) + np.uint32(0x38495AB5)).view(
        np.int32)
    return (_abs31_kernel(h1 ^ t) % V).astype(np.int32)


def test_kernel_abs_wraps_as_the_reference():
    """The abs step alone: INT32_MIN & 0x7FFFFFFF = 0, as jnp.abs wraps."""
    h = np.array([-2**31, -2**31 + 1, -1, 0, 1, 2**31 - 1, -12345], np.int32)
    want = np.asarray(jnp.abs(jnp.asarray(h)) & 0x7FFFFFFF)
    np.testing.assert_array_equal(_abs31_kernel(h), want)
    assert _abs31_kernel(h)[0] == 0


@pytest.mark.parametrize("table_size", [1, 1000, 1 << 18, 2**31 - 1])
@pytest.mark.parametrize("k", [1, 2, 3, 32])
def test_kernel_multi_hash_matches_jax(k, table_size):
    rng = np.random.default_rng(k + table_size % 997)
    sig = np.concatenate([
        np.array([0, 1, -1, -2**31, 2**31 - 1, -2**31 + 1, -7], np.int32),
        rng.integers(-2**31, 2**31 - 1, 3000, dtype=np.int64).astype(
            np.int32),
    ])
    want = np.asarray(jax_multi_hash_ids(jnp.asarray(sig), k, table_size))
    got = np.stack([_probe_id_kernel(sig, j, table_size) for j in range(k)],
                   axis=-1)
    np.testing.assert_array_equal(got, want)
