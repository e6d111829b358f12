"""The port's route-rank plain version against the JAX reference.

``route_rank`` on CPU tensors runs :func:`repro_torch.kernels.route.ref.
route_rank_ref`; it must equal JAX's ``route_rank_ref`` exactly (ranks
and counts are integers), with pad ids (== S), negative ids and all rows
on one shard.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.route.ref import route_rank_ref as jax_route_rank_ref
from repro_torch.kernels.route.ops import route_rank


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
