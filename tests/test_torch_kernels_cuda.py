"""The hand-written CUDA kernels against their plain PyTorch versions.

These tests need an NVIDIA GPU and the CUDA toolkit (the kernels are
built with ``nvcc`` at first use); without a card they skip.  Run them on
the GPU with ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_kernels_cuda.py``.  This file imports neither ``jax`` nor
the JAX package, so it runs where only PyTorch is installed.

Tolerances: both kernels must equal their plain versions exactly — the
ingest kernel on all six state arrays (f32 compared as int32 bit
patterns), the route kernel on ranks and counts (integers).  The whole
store on the GPU equals the same store on the CPU: state bit-exact,
COUNT / MAX bit-exact, SUM / MEAN within ``rtol=1e-5`` (masked ring
sums reduce in a device-chosen order), STD within that plus the
cancellation bound stated at the assertion.
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import preagg as pg
from repro_torch.core import storage as st
from repro_torch.kernels.ingest.ops import fused_ingest
from repro_torch.kernels.ingest.ref import fused_ingest_ref
from repro_torch.kernels.route.ops import route_rank
from repro_torch.kernels.route.ref import route_rank_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


K, C, F, NB, BS = 4096, 64, 2, 32, 64


def _state(dev):
    r = st.ring_init(K, C, F, dev)
    b = pg.bucket_init(K, NB, F, BS, dev)
    return [r.ts, r.vals, r.cursor, b.stats, b.bitmap, b.bucket]


def _batch(rng, n, lo, hi, hot=0, pad=0):
    key = rng.integers(0, K, n).astype(np.int32)
    key[:hot] = 11
    ts = rng.integers(lo, hi, n).astype(np.int32)
    o = np.lexsort((ts, key))
    key, ts = key[o], ts[o]
    vals = rng.gamma(1.5, 60.0, (n, F)).astype(np.float32)
    key = np.concatenate([key, np.full(pad, K, np.int32)])
    ts = np.concatenate([ts, np.full(pad, ts[-1] if n else lo, np.int32)])
    vals = np.concatenate([vals, np.zeros((pad, F), np.float32)])
    return key, ts, vals


def _assert_same(a_list, b_list, where):
    for i, (a, b) in enumerate(zip(a_list, b_list)):
        a, b = a.cpu(), b.cpu()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f"{where}: state array {i} differs"


def test_fused_ingest_kernel_matches_ref(cuda):
    """Sequential batches: ordinary, a key with 150 rows (> C) in one
    batch, bucket-slot reuse (stale resets), trailing pads, an all-pad
    batch — six arrays bit-exact after each."""
    rng = np.random.default_rng(0)
    sk, sr = _state(cuda), _state(cuda)
    plan = [
        (8192, 0, 1500, 0, 0),
        (8192, 1500, 1900, 150, 100),
        (3000, 1900, 3000, 0, 1096),
        (0, 3000, 3000, 0, 64),
        (8192, 4000, 5500, 0, 0),  # slots of buckets 0..23 reused
    ]
    for step, (n, lo, hi, hot, pad) in enumerate(plan):
        k, t, v = (torch.as_tensor(x, device=cuda)
                   for x in _batch(rng, n, lo, hi, hot, pad))
        fused_ingest(*sk, k, t, v, bucket_size=BS)
        fused_ingest_ref(*sr, k, t, v, bucket_size=BS)
        torch.cuda.synchronize()
        _assert_same(sk, sr, f"step {step}")


def test_fused_ingest_kernel_counts_launches(cuda):
    rng = np.random.default_rng(1)
    s = _state(cuda)
    k, t, v = (torch.as_tensor(x, device=cuda)
               for x in _batch(rng, 256, 0, 500))
    before = kernels.LAUNCHES["fused_ingest"]
    fused_ingest(*s, k, t, v, bucket_size=BS)
    fused_ingest_ref(*s, k, t, v, bucket_size=BS)
    assert kernels.LAUNCHES["fused_ingest"] == before + 1


@pytest.mark.parametrize("num_shards", [1, 8, 64])
@pytest.mark.parametrize("n", [1, 31, 1024, 1025, 4096, 10_000])
def test_route_rank_kernel_matches_ref(cuda, n, num_shards):
    """Exact ranks and counts, with pad ids (== S) and negative ids."""
    rng = np.random.default_rng(n * 100 + num_shards)
    shard = rng.integers(-1, num_shards + 1, n).astype(np.int32)
    x = torch.as_tensor(shard, device=cuda)
    before = kernels.LAUNCHES["route_rank"]
    rk, ck = route_rank(x, num_shards=num_shards)
    assert kernels.LAUNCHES["route_rank"] == before + 1
    rr, cr = route_rank_ref(x, num_shards)
    torch.cuda.synchronize()
    assert torch.equal(rk, rr) and torch.equal(ck, cr)


def test_route_rank_all_rows_one_shard(cuda):
    x = torch.full((4096,), 5, dtype=torch.int32, device=cuda)
    rk, ck = route_rank(x, num_shards=8)
    assert torch.equal(rk.cpu(), torch.arange(4096, dtype=torch.int32))
    assert ck.cpu().tolist() == [0, 0, 0, 0, 0, 4096, 0, 0]


def test_sharded_store_on_gpu_matches_cpu(cuda):
    """The fraud service's sharded store on the GPU (both kernels) equals
    the same store on the CPU (plain versions)."""
    from repro_torch.convert import online_state_to_numpy
    from repro_torch.data.synthetic import fraud_transactions
    from repro_torch.scenarios import fraud_view
    from repro_torch.serve.service import FeatureService

    kw = dict(num_keys=4096, sharded=True, num_shards=8, capacity=64,
              num_buckets=512, bucket_size=64)
    gpu = FeatureService.build("g", fraud_view(), device="cuda", **kw)
    cpu = FeatureService.build("c", fraud_view(), device="cpu", **kw)
    rng = np.random.default_rng(5)
    for i in range(4):
        b = fraud_transactions(rng, 4000, 4096, i * 5000, (i + 1) * 5000)
        gpu.store.ingest(dict(b))
        cpu.store.ingest(dict(b))
    launches = kernels.LAUNCHES["route_rank"]
    req = fraud_transactions(rng, 1000, 4096, 20_000, 20_600)
    a = gpu.request(dict(req))
    b = cpu.request(dict(req))
    assert kernels.LAUNCHES["route_rank"] > launches
    for f in ("tx_count_1h", "tx_count_50", "amt_max_6h", "big_ratio_1h"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    for f in ("amt_sum_1h", "amt_mean_1h", "amt_sum_6h"):
        np.testing.assert_allclose(a[f], b[f], rtol=1e-5, err_msg=f)
    # STD = sqrt(sumsq/n - m*m): a sum-order difference of ~2^-24 m^2 in
    # the variance moves a near-zero STD by up to ~2^-12 |m|
    np.testing.assert_allclose(
        a["amt_std_1h"], b["amt_std_1h"], rtol=1e-5,
        atol=2.0 ** -10 * float(np.abs(b["amt_mean_1h"]).max()),
    )
    sa = online_state_to_numpy(gpu.store.state)
    sb = online_state_to_numpy(cpu.store.state)
    for name in sa:
        np.testing.assert_array_equal(
            sa[name].view(np.int32), sb[name].view(np.int32), err_msg=name
        )
