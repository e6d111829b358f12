"""The port's route plain versions against the JAX reference.

``route_rank`` on CPU tensors runs :func:`repro_torch.kernels.route.ref.
route_rank_ref`; it must equal JAX's ``route_rank_ref`` exactly (ranks
and counts are integers), with pad ids (== S), negative ids and all rows
on one shard.

``route_keys`` on CPU tensors runs ``route_keys_ref``, the composition the
CUDA kernel replaces; it must equal, exactly, JAX's
``KeyPermutation.device_call`` followed by ``% S``, ``// S``, JAX's
``route_rank_ref`` and the valid-masked count.  A numpy replay of the
kernel's integer arithmetic (``kernels/csrc/route_rank.cu``: uint32
multiplies, arithmetic shifts on int32, the salt masked to 31 bits) must
equal JAX's ``mix32`` and ``KeyPermutation`` bit for bit on edge ints.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hashing import KeyPermutation as JaxKeyPermutation
from repro.core.hashing import mix32 as jax_mix32
from repro.kernels.route.ref import route_rank_ref as jax_route_rank_ref
from repro_torch.core.hashing import KeyPermutation
from repro_torch.kernels.route.ops import route_keys, route_rank

INT32_MIN, INT32_MAX = -2**31, 2**31 - 1


@pytest.mark.parametrize("num_shards", [1, 3, 8, 64])
@pytest.mark.parametrize("n", [1, 17, 1000, 4096])
def test_route_rank_matches_jax(n, num_shards):
    rng = np.random.default_rng(n + num_shards)
    shard = rng.integers(-1, num_shards + 1, n).astype(np.int32)
    rank, counts = route_rank(torch.from_numpy(shard), num_shards=num_shards)
    jr, jc = jax_route_rank_ref(jnp.asarray(shard), num_shards)
    np.testing.assert_array_equal(rank.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    assert counts.sum() == ((shard >= 0) & (shard < num_shards)).sum()


def test_route_rank_all_rows_one_shard():
    shard = np.full(4096, 5, np.int32)
    rank, counts = route_rank(torch.from_numpy(shard), num_shards=8)
    jr, jc = jax_route_rank_ref(jnp.asarray(shard), 8)
    np.testing.assert_array_equal(rank.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(rank.numpy(), np.arange(4096))


def _pad(keys, valid, m):
    """The request path's padding: the last key repeated, marked invalid."""
    pad = m - len(keys)
    return (np.concatenate([keys, np.full(pad, keys[-1], np.int32)]),
            np.concatenate([valid, np.zeros(pad, bool)]))


@pytest.mark.parametrize("num_shards", [1, 3, 8, 64])
@pytest.mark.parametrize("upper", [200, 12_289, 1 << 19, (1 << 19) + 1])
def test_route_keys_plain_matches_jax(upper, num_shards):
    """Five outputs exact: JAX's walk, % S, // S, its rank, masked counts."""
    rng = np.random.default_rng(upper + num_shards)
    keys = rng.integers(0, upper, 300).astype(np.int32)
    keys[:3] = [0, upper - 1, upper // 2]
    keys, valid = _pad(keys, rng.random(300) < 0.8, 512)
    perm = KeyPermutation(upper)
    local, shard, rank, counts, vcounts = route_keys(
        torch.as_tensor(keys), torch.as_tensor(valid), perm,
        num_shards=num_shards)
    routed = np.asarray(JaxKeyPermutation(upper).device_call(
        jnp.asarray(keys)))
    jshard = routed % num_shards
    jr, jc = jax_route_rank_ref(jnp.asarray(jshard), num_shards)
    np.testing.assert_array_equal(shard.numpy(), jshard)
    np.testing.assert_array_equal(local.numpy(), routed // num_shards)
    np.testing.assert_array_equal(rank.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(
        vcounts.numpy(), np.bincount(jshard[valid], minlength=num_shards))
    assert all(t.dtype == torch.int32
               for t in (local, shard, rank, counts, vcounts))


def test_route_keys_out_of_domain_keys_count_nowhere():
    """A key outside [0, upper) is not walked: local = shard = -1, rank 0,
    counted nowhere; the other rows route as without it."""
    perm = KeyPermutation(1000)
    keys = np.array([5, -1, 17, 1000, INT32_MAX, 17, INT32_MIN, 999],
                    np.int32)
    inside = (keys >= 0) & (keys < 1000)
    valid = np.ones(len(keys), bool)
    local, shard, rank, counts, vcounts = route_keys(
        torch.as_tensor(keys), torch.as_tensor(valid), perm, num_shards=4)
    assert (local.numpy()[~inside] == -1).all()
    assert (shard.numpy()[~inside] == -1).all()
    assert (rank.numpy()[~inside] == 0).all()
    l2, s2, r2, c2, v2 = route_keys(
        torch.as_tensor(keys[inside]), torch.as_tensor(valid[inside]), perm,
        num_shards=4)
    np.testing.assert_array_equal(local.numpy()[inside], l2.numpy())
    np.testing.assert_array_equal(shard.numpy()[inside], perm(keys[inside]) % 4)
    np.testing.assert_array_equal(rank.numpy()[inside], r2.numpy())
    np.testing.assert_array_equal(counts.numpy(), c2.numpy())
    np.testing.assert_array_equal(vcounts.numpy(), v2.numpy())
    assert counts.sum() == inside.sum()


# -- the kernel's integer arithmetic, replayed in numpy as the .cu writes it


def _mix32_kernel(x, salt):
    """``mix32`` of route_rank.cu on int32 lanes: the salt masked to 31
    bits, multiplies on uint32, shifts arithmetic on int32."""
    h = np.asarray(x, np.int32) ^ np.int32(salt & 0x7FFFFFFF)
    h = h ^ (h >> 16)
    h = (h.view(np.uint32) * np.uint32(0x85EBCA6B)).view(np.int32)
    h = h ^ ((h >> 13) & np.int32(0x0007FFFF))
    h = (h.view(np.uint32) * np.uint32(0xC2B2AE35)).view(np.int32)
    return h ^ ((h >> 16) & np.int32(0x0000FFFF))


def _feistel_once_kernel(x, half, mask, rounds, salt):
    """``feistel_once`` of route_rank.cu; each round's salt is formed on
    uint32, ``salt + 0x9E37 (r + 1)``, from the salt's low 32 bits."""
    left, right = x >> half, x & np.int32(mask)
    for r in range(rounds):
        s = (salt + 0x9E37 * (r + 1)) & 0xFFFFFFFF
        g = _mix32_kernel(right, s) & np.int32(mask)
        left, right = right, left ^ g
    return (left << half) | right


def _walk_kernel(keys, perm):
    """The kernel's walk: once, then once again while past the domain."""
    x = _feistel_once_kernel(keys, perm.half, perm.mask, perm.rounds,
                             perm.salt & 0xFFFFFFFF)
    while (x >= perm.upper).any():
        bad = x >= perm.upper
        x[bad] = _feistel_once_kernel(x[bad], perm.half, perm.mask,
                                      perm.rounds, perm.salt & 0xFFFFFFFF)
    return x


@pytest.mark.parametrize("salt", [0, 0x9E37, 0x7FFFFFFF, 0x80000005, -3])
def test_kernel_mix32_matches_jax_on_edge_ints(salt):
    edges = np.array([0, 1, -1, INT32_MIN, INT32_MAX, INT32_MIN + 1,
                      INT32_MAX - 1, 0xFFFF, 0x7FFF, 0x10000, 0x3FF,
                      (1 << 15) - 1], np.int32)
    rand = np.random.default_rng(7).integers(INT32_MIN, INT32_MAX, 4000,
                                             dtype=np.int64).astype(np.int32)
    x = np.concatenate([edges, rand])
    # the kernel forms the salt on uint32; jax masks the Python int
    np.testing.assert_array_equal(
        _mix32_kernel(x, salt & 0xFFFFFFFF),
        np.asarray(jax_mix32(jnp.asarray(x), salt=salt)))


@pytest.mark.parametrize("salt", [0, 12345, 0x7FFFFFFF])
@pytest.mark.parametrize("upper", [2, 200, 12_289, 1 << 19, (1 << 19) + 1,
                                   (1 << 30) - 7])
def test_kernel_feistel_walk_matches_jax(upper, salt):
    perm = KeyPermutation(upper, salt=salt)
    jperm = JaxKeyPermutation(upper, salt=salt)
    rng = np.random.default_rng(upper % 1000 + salt % 7)
    keys = np.concatenate([
        np.array([0, 1, upper - 1, min(perm.mask, upper - 1),
                  upper // 2], np.int32),
        rng.integers(0, upper, 3000).astype(np.int32),
    ])
    got = _walk_kernel(keys, perm)
    np.testing.assert_array_equal(
        got, np.asarray(jperm.device_call(jnp.asarray(keys))))
    np.testing.assert_array_equal(got, jperm(keys))
    # one pass on the whole Feistel domain's edges, against the host mirror
    edges = np.array([0, 1, perm.mask, perm.mask + 1, perm.size - 1],
                     np.int32)
    np.testing.assert_array_equal(
        _feistel_once_kernel(edges, perm.half, perm.mask, perm.rounds,
                             salt & 0xFFFFFFFF),
        perm._once(edges.astype(np.int64)))
