"""The port's hashing against the JAX package's, bit for bit.

``KeyPermutation``: the port's device walk (``device_call`` +
``finish_walk``) == the port's host ``__call__`` == JAX ``device_call`` ==
JAX ``__call__``, on non-power-of-two domains and several salts;
``inverse`` round-trips.  ``mix32`` / ``mix64`` / ``fold_hash`` /
``row_bitmap`` equal JAX's on int32 and float32 inputs, and ``mix32_np``
equals JAX's on negative int64 inputs.  Tolerance: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregates as jax_ag
from repro.core import hashing as jax_h
from repro_torch.core import aggregates as ag
from repro_torch.core import hashing as h


@pytest.mark.parametrize("upper", [1, 2, 5, 100, 1000, 12_289, 1 << 14])
@pytest.mark.parametrize("salt", [0, 3, 77])
def test_key_permutation_device_host_jax_agree(upper, salt):
    keys = np.arange(min(upper, 4096), dtype=np.int64)
    perm, jperm = h.KeyPermutation(upper, salt=salt), jax_h.KeyPermutation(
        upper, salt=salt
    )
    out, walking = perm.device_call(torch.as_tensor(keys, dtype=torch.int32))
    dev = perm.finish_walk(out).numpy()
    host = perm(keys)
    np.testing.assert_array_equal(dev, host)
    np.testing.assert_array_equal(host, jperm(keys))
    np.testing.assert_array_equal(
        host, np.asarray(jperm.device_call(jnp.asarray(keys, jnp.int32)))
    )
    np.testing.assert_array_equal(perm.inverse(host), keys)
    if not bool(walking):
        np.testing.assert_array_equal(out.numpy(), host)


def test_device_walk_flag_is_set_only_when_needed():
    """A one-pass walk leaves ids outside a sparse domain; the flag says so
    and ``finish_walk`` completes them to the host answer."""
    perm = h.KeyPermutation(5, salt=1)
    perm.device_passes = 1
    keys = torch.arange(5, dtype=torch.int32)
    out, walking = perm.device_call(keys)
    assert bool(walking) == bool((out >= 5).any())
    np.testing.assert_array_equal(perm.finish_walk(out).numpy(), perm(np.arange(5)))


@pytest.mark.parametrize("salt", [0, 1, 77, 0x7FFFFFFF, 123_456_789])
def test_mixers_match_jax(salt):
    rng = np.random.default_rng(salt % 1000)
    x = np.concatenate([
        rng.integers(-2**31, 2**31, 4096).astype(np.int32),
        np.array([0, 1, -1, 2**31 - 1, -2**31], np.int32),
    ])
    f = np.concatenate([
        rng.normal(size=1000).astype(np.float32) * 300,
        np.array([0.0, -0.0, 1.0, -1.0, 3.0e38, -3.0e38], np.float32),
    ])
    for v in (x, f):
        t, j = torch.from_numpy(v), jnp.asarray(v)
        np.testing.assert_array_equal(
            h.mix32(t, salt).numpy(), np.asarray(jax_h.mix32(j, salt)))
        for bits in (5, 20, 31, 32):
            np.testing.assert_array_equal(
                h.mix64(t, salt, bits).numpy(),
                np.asarray(jax_h.mix64(j, salt, bits)))
    np.testing.assert_array_equal(
        h.fold_hash([torch.from_numpy(x), torch.from_numpy(x[::-1].copy())],
                    salt=salt).numpy(),
        np.asarray(jax_h.fold_hash([jnp.asarray(x), jnp.asarray(x[::-1])],
                                   salt=salt)),
    )
    np.testing.assert_array_equal(
        ag.row_bitmap(torch.from_numpy(f)).numpy(),
        np.asarray(jax_ag.row_bitmap(jnp.asarray(f))),
    )


def test_mix32_np_negative_int64_matches_jax():
    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.integers(-2**62, 2**62, 2000, dtype=np.int64),
        np.array([-1, -2**31, -2**31 - 1, -2**63, 2**63 - 1], np.int64),
    ])
    for salt in (0, 5, 0x9E37):
        np.testing.assert_array_equal(
            h.mix32_np(x, salt), jax_h.mix32_np(x, salt)
        )
