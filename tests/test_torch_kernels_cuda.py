"""The hand-written CUDA kernels against their plain PyTorch versions.

These tests need an NVIDIA GPU and the CUDA toolkit (the kernels are
built with ``nvcc`` at first use); without a card they skip.  Run them on
the GPU with ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_kernels_cuda.py``.  This file imports neither ``jax`` nor
the JAX package, so it runs where only PyTorch is installed.

Tolerances: the ingest, route and fold-levels kernels must equal their
plain versions exactly — the ingest kernel on all six state arrays (f32
compared as int32 bit patterns), the route kernel on ranks and counts
(integers), the fold-levels kernel on every level (NaN payloads and
``±0.0`` included).  The window-stats kernel's count, min and max are
exact; its sum and sumsq reduce in the kernel's tree order, within
``rtol=1e-5, atol=1e-3``.  The signature-embedding kernel equals its
plain version bit for bit (float32 and bfloat16 tables).  The WKV6
kernel is held to its chunked plain version at ``atol = rtol = 1e-4`` and
to the recurrence at ``5e-4`` (float32 products summed in another order);
``RWKV6LM`` on the card to the same model on the CPU at ``1e-3`` on
logits and states (float32 smoke model; cuBLAS and the CPU's BLAS sum in
different orders, over two layers and three decode steps).  The flash
attention kernel is held to its plain version at the reference's
``atol = rtol = 2e-5`` (float32) and ``3e-2`` (bf16); ``DecoderLM`` on the
card (B6 in every prefill) to the same model on the CPU (``gqa_attention``)
at ``1e-3`` in float32, where the two attentions are one function, and at
eight bf16 steps of the largest logit in bf16, where both round the
weights p to bf16 but sum in other orders.  The whole
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
from repro_torch.kernels.flash_attention.ops import (
    attention,
    launch_flash_attention,
    plan_attention,
)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ingest.ops import fused_ingest
from repro_torch.kernels.ingest.ref import fused_ingest_ref
from repro_torch.kernels.route.ops import route_rank
from repro_torch.kernels.signature.ops import (
    launch_signature_embed,
    signature_embed,
)
from repro_torch.kernels.signature.ref import signature_embed_ref
from repro_torch.kernels.route.ref import route_rank_ref
from repro_torch.kernels.window_agg.ops import fold_levels, window_stats
from repro_torch.kernels.window_agg.ref import (
    fold_levels_ref,
    fold_num_levels,
    window_stats_ref,
)
from repro_torch.kernels.wkv6.ops import (
    launch_wkv6,
    plan_wkv6,
    wkv6,
    wkv6_chunked,
)
from repro_torch.kernels.wkv6.ref import LOG_W_MIN, wkv6_ref

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


def test_fused_ingest_kernel_hot_key_and_distinct_keys(cuda):
    """One key with 20,000 rows over 16 buckets in one batch (its warp's
    path: a 32-way end search, ring writes 32 at a time, each bucket
    folded in row order), then a batch of 65,536 distinct keys (a run of
    one row each) into a 65,536-key state: six arrays bit-exact."""
    rng = np.random.default_rng(3)
    sk, sr = _state(cuda), _state(cuda)
    n = 30_000
    key = rng.integers(0, K, n).astype(np.int32)
    key[:20_000] = 17
    ts = rng.integers(6000, 7000, n).astype(np.int32)
    o = np.lexsort((ts, key))
    vals = rng.gamma(1.5, 60.0, (n, F)).astype(np.float32)
    k, t, v = (torch.as_tensor(x, device=cuda)
               for x in (key[o], ts[o], vals[o]))
    kernels.reset_launches()
    fused_ingest(*sk, k, t, v, bucket_size=BS)
    assert kernels.LAUNCHES["fused_ingest"] == 1
    fused_ingest_ref(*sr, k, t, v, bucket_size=BS)
    torch.cuda.synchronize()
    _assert_same(sk, sr, "hot key of 20,000 rows")
    keys = 1 << 16
    big = [st.ring_init(keys, 8, F, cuda), pg.bucket_init(keys, 4, F, BS, cuda)]
    sk = [big[0].ts, big[0].vals, big[0].cursor, big[1].stats,
          big[1].bitmap, big[1].bucket]
    sr = [x.clone() for x in sk]
    k = torch.randperm(keys, device=cuda).sort().values.to(torch.int32)
    t = torch.as_tensor(rng.integers(0, 200, keys).astype(np.int32),
                        device=cuda)
    v = torch.as_tensor(rng.gamma(1.5, 60.0, (keys, F)).astype(np.float32),
                        device=cuda)
    fused_ingest(*sk, k, t, v, bucket_size=BS)
    fused_ingest_ref(*sr, k, t, v, bucket_size=BS)
    torch.cuda.synchronize()
    _assert_same(sk, sr, "65,536 distinct keys")


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


# float32 patterns: ±0, NaNs of both signs and payloads, ±inf, ±1
_SPECIAL = np.array(
    [0x0, 0x80000000, 0x7FC00000, 0xFFC00000, 0x7FC00001, 0x7F800001,
     0xFF800005, 0x7F800000, 0xFF800000, 0x3F800000, 0xBF800000],
    np.uint32,
).view(np.float32)


def _seg(key):
    n = len(key)
    start = np.ones(n, bool)
    start[1:] = key[1:] != key[:-1]
    return np.maximum.accumulate(np.where(start, np.arange(n), 0)).astype(
        np.int32)


@pytest.mark.parametrize("op", ["min", "max", "or"])
@pytest.mark.parametrize("n", [1, 5, 1000, 4097, (1 << 20) + 3])
@pytest.mark.parametrize("layout", ["segments", "one_segment", "all_starts"])
def test_fold_levels_kernel_matches_ref(cuda, op, n, layout):
    rng = np.random.default_rng(n * 7 + len(op) + len(layout))
    key = {"segments": np.sort(rng.integers(0, 1 + n // 50, n)),
           "one_segment": np.zeros(n),
           "all_starts": np.arange(n)}[layout].astype(np.int32)
    if op == "or":
        x = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    else:
        x = rng.normal(size=n).astype(np.float32)
        special = rng.random(n) < 0.1
        x[special] = rng.choice(_SPECIAL, int(special.sum()))
    xt = torch.as_tensor(x, device=cuda)
    st = torch.as_tensor(_seg(key), device=cuda)
    before = kernels.LAUNCHES["fold_levels"]
    got = fold_levels(xt, st, op=op)
    # one cooperative launch a call, long rows included
    assert kernels.LAUNCHES["fold_levels"] == before + 1
    want = fold_levels_ref(xt, st, op)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (fold_num_levels(n), n)
    _assert_same([got], [want], f"fold_levels {op} n={n} {layout}")


def _poisson_keys(rng, n, cards):
    return np.sort(rng.integers(0, cards, n)).astype(np.int32)


@pytest.mark.parametrize("op,case", [
    *[(op, case) for op in ("min", "max", "or")
      for case in ("halo_edges", "hot_key")],
    ("min", "special_long"), ("max", "special_long"),  # float specials
])
def test_fold_levels_kernel_halo_and_hot_key(cuda, op, case):
    """Segments just shorter and just longer than the halo (FOLD_HALO - 1
    ... FOLD_HALO + 2 rows, crossing tile starts), a hot key of 2^20 rows
    among Poisson(32) segments, and NaN / ±0 / ±inf in segments longer
    than the halo: bit-exact, one launch."""
    from repro_torch.kernels.window_agg.ops import FOLD_HALO

    rng = np.random.default_rng(len(op) * 31 + len(case))
    if case == "halo_edges":
        n = 1 << 20
        lens = rng.choice([FOLD_HALO - 1, FOLD_HALO, FOLD_HALO + 1,
                           FOLD_HALO + 2], n // FOLD_HALO)
        key = np.repeat(np.arange(len(lens)), lens)[:n].astype(np.int32)
    elif case == "hot_key":
        n = 1 << 22
        key = _poisson_keys(rng, n, n // 32)
        key[1_000_000:1_000_000 + (1 << 20)] = key[1_000_000]
        key = np.sort(key)
    else:
        n = (1 << 20) + 17
        key = _poisson_keys(rng, n, 512)  # ~2,048 rows a segment
    if op == "or":
        x = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    else:
        x = rng.normal(size=n).astype(np.float32)
        special = rng.random(n) < (0.3 if case == "special_long" else 0.05)
        x[special] = rng.choice(_SPECIAL, int(special.sum()))
    xt = torch.as_tensor(x, device=cuda)
    st = torch.as_tensor(_seg(key), device=cuda)
    kernels.reset_launches()
    got = fold_levels(xt, st, op=op)
    assert kernels.LAUNCHES["fold_levels"] == 1
    want = fold_levels_ref(xt, st, op)
    torch.cuda.synchronize()
    _assert_same([got], [want], f"fold_levels {op} {case}")


def _gpu_store(cuda, rng, keys=512, rows=20_000):
    from repro_torch.data.synthetic import fraud_transactions
    from repro_torch.scenarios import fraud_view
    from repro_torch.serve.service import FeatureService

    svc = FeatureService.build(
        "w", fraud_view(), num_keys=keys, sharded=True, num_shards=4,
        capacity=64, num_buckets=512, bucket_size=64, device="cuda",
    )
    for i in range(4):
        svc.store.ingest(fraud_transactions(rng, rows // 4, keys,
                                             i * 9000, (i + 1) * 9000))
    return svc.store


@pytest.mark.parametrize("t_lo,t_hi", [(30_000, 40_000), (0, 300)])
def test_window_stats_kernel_matches_ref(cuda, t_lo, t_hi):
    """On a sharded fraud store's flat state (2 lanes), late and early
    requests: count, min, max exact; sums within rtol 1e-5."""
    rng = np.random.default_rng(t_lo + 3)
    store = _gpu_store(cuda, rng)
    s = store._flat_state()
    keys = rng.integers(0, 512, 1000)
    shard, local = store._route_ids(keys)
    qk = torch.as_tensor((shard * store.num_keys + local).astype(np.int32),
                         device=cuda)
    qt = torch.as_tensor(rng.integers(t_lo, t_hi, 1000).astype(np.int32),
                         device=cuda)
    ql = torch.as_tensor(rng.gamma(1.5, 60.0, (1000, 2)).astype(np.float32),
                         device=cuda)
    args = (s.ring.ts, s.ring.vals, s.bagg.stats, s.bagg.bucket, qk, qt, ql)
    before = kernels.LAUNCHES["window_stats"]
    got = window_stats(*args, windows=(3600, 21600), bucket_size=64)
    assert kernels.LAUNCHES["window_stats"] == before + 1
    want = window_stats_ref(*args, windows=(3600, 21600), bucket_size=64)
    torch.cuda.synchronize()
    got, want = got.cpu().numpy(), want.cpu().numpy()
    for i in (1, 2, 3):
        np.testing.assert_array_equal(got[..., i].view(np.int32),
                                      want[..., i].view(np.int32))
    for i in (0, 4):
        np.testing.assert_allclose(got[..., i], want[..., i], rtol=1e-5,
                                   atol=1e-3)


def test_window_stats_rejects_out_of_range_keys(cuda):
    z = torch.zeros
    args = (z((4, 8), dtype=torch.int32, device=cuda),
            z((4, 8, 1), device=cuda), z((4, 16, 1, 5), device=cuda),
            z((4, 16), dtype=torch.int32, device=cuda),
            torch.tensor([0, 4], dtype=torch.int32, device=cuda),
            z(2, dtype=torch.int32, device=cuda), z((2, 1), device=cuda))
    with pytest.raises(ValueError, match="outside"):
        window_stats(*args, windows=(60,), bucket_size=8)


def test_offline_engine_on_gpu_matches_cpu(cuda):
    """The fraud view offline on the GPU (fold-levels kernel) equals the
    CPU run: MAX and counts exact; sums within the mean-centering bound
    (the mean reduces in a device-chosen order)."""
    from repro_torch.core.engine import OfflineEngine
    from repro_torch.data.synthetic import fraud_transactions
    from repro_torch.scenarios import fraud_view

    rng = np.random.default_rng(11)
    cols = fraud_transactions(rng, 50_000, 1024, 0, 86_400)
    perm = rng.permutation(50_000)
    cols = {c: v[perm] for c, v in cols.items()}
    before = kernels.LAUNCHES["fold_levels"]
    a = OfflineEngine(device="cuda").compute(fraud_view(), cols)
    assert kernels.LAUNCHES["fold_levels"] > before
    b = OfflineEngine(device="cpu").compute(fraud_view(), cols)
    for f in ("tx_count_1h", "tx_count_50", "amt_max_6h", "big_ratio_1h"):
        np.testing.assert_array_equal(a[f].cpu().numpy(), b[f].numpy(),
                                      err_msg=f)
    amax = float(cols["amount"].max())
    cnt = float(b["tx_count_1h"].max())
    for f in ("amt_sum_1h", "amt_sum_6h", "amt_mean_1h"):
        np.testing.assert_allclose(a[f].cpu().numpy(), b[f].numpy(),
                                   rtol=1e-5, atol=1e-5 * amax * cnt,
                                   err_msg=f)


@pytest.mark.parametrize("mode", ["naive", "preagg"])
def test_verify_view_on_gpu_passes(cuda, mode):
    """One hour of traffic, ~10 rows per card (the regime chip_smoke.py
    checks; over a day the STD tolerance of verify_view does not hold in
    either package — ROADMAP Queue C)."""
    from repro_torch.core.consistency import verify_view
    from repro_torch.data.synthetic import fraud_transactions
    from repro_torch.scenarios import fraud_view

    rng = np.random.default_rng(12)
    cols = fraud_transactions(rng, 20_000, 2048, 0, 3600)
    rep = verify_view(fraud_view(), cols, num_keys=2048, capacity=256,
                      num_buckets=512, bucket_size=64, mode=mode,
                      device="cuda")
    assert rep.passed, rep.summary() + f" per-feature: {rep.per_feature}"


def _sig_case(dev, V, D, N, k, dtype, seed=13):
    g = torch.Generator().manual_seed(seed)
    table = torch.randn((V, D), generator=g).to(dtype).to(dev)
    ids = torch.randint(0, V, (N, k), generator=g, dtype=torch.int32).to(dev)
    w = torch.randn((k,), generator=g).to(dev)
    return table, ids, w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V,D,N,k", [
    (4096, 512, 4096, 2),     # the scoring shapes, table cut to 4096 rows
    (1000, 64, 1, 1),
    (1000, 130, 777, 3),      # D not a multiple of 4 floats / 8 bf16
    (50, 7, 300, 4),
    (1 << 16, 8, 2048, 32),   # the most probes the kernel takes
])
def test_signature_embed_kernel_matches_ref(cuda, V, D, N, k, dtype):
    table, ids, w = _sig_case(cuda, V, D, N, k, dtype)
    out = torch.empty((N, D), dtype=dtype, device=cuda)
    launch_signature_embed(table, ids, w, out)
    want = signature_embed_ref(table, ids, w).to(dtype)
    torch.cuda.synchronize()
    a, b = out.cpu(), want.cpu()
    if dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    else:
        a, b = a.view(torch.int16), b.view(torch.int16)
    assert torch.equal(a, b)


def test_signature_embed_kernel_unaligned_and_bad_ids(cuda):
    """A table view that starts off a 16-byte boundary takes the scalar
    path; an out-of-range id gives a NaN row, the other rows stay exact."""
    table, ids, w = _sig_case(cuda, 513, 64, 100, 2, torch.float32)
    view = table[1:]                       # 256-byte row offset: aligned
    odd = table.reshape(-1)[1:1 + 512 * 63].reshape(512, 63)  # unaligned
    for t in (view, odd):
        out = torch.empty((100, t.shape[1]), device=cuda)
        launch_signature_embed(t, ids % 512, w, out)
        want = signature_embed_ref(t, ids % 512, w)
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    bad = (ids % 512).clone()
    bad[7, 1] = 512
    out = torch.empty((100, 64), device=cuda)
    launch_signature_embed(view, bad, w, out)
    torch.cuda.synchronize()
    assert torch.isnan(out[7]).all()
    keep = torch.arange(100, device=cuda) != 7
    want = signature_embed_ref(view, ids % 512, w)
    assert torch.equal(out[keep].view(torch.int32), want[keep].view(torch.int32))


def test_signature_embed_dispatch_counts_launches(cuda):
    table, _, w = _sig_case(cuda, 1 << 12, 128, 1, 2, torch.float32)
    sig = torch.arange(0, 5000, dtype=torch.int32, device=cuda) * 7919
    before = kernels.LAUNCHES["signature_embed"]
    out = signature_embed(table, sig, w, num_hashes=2)
    assert kernels.LAUNCHES["signature_embed"] == before + 1
    cpu = signature_embed(table.cpu(), sig.cpu(), w.cpu(), num_hashes=2)
    assert torch.equal(out.cpu().view(torch.int32), cpu.view(torch.int32))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        signature_embed(table.half(), sig, w, num_hashes=2)
    with pytest.raises(ValueError, match="mixed devices"):
        signature_embed(table, sig.cpu(), w, num_hashes=2)


def test_scoring_service_on_gpu_matches_cpu(cuda):
    """The scoring path on the card (B5 launched) against the same path on
    the CPU with the same weights and store state: scores within
    ``atol=1e-4`` (float32 model; cuBLAS and the CPU's BLAS
    sum in different orders)."""
    from repro_torch.configs.featinsight_fraud import smoke_config
    from repro_torch.data.synthetic import fraud_transactions
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.scenarios import fraud_view
    from repro_torch.serve.service import FeatureService, ScoringService

    rng = np.random.default_rng(14)
    hist = fraud_transactions(rng, 5000, 256, 0, 20_000)
    table = rng.normal(0, 0.02, (1 << 12, 128)).astype(np.float32)
    model = DecoderLM(smoke_config(), seed=1, device="cuda")
    scores = {}
    for dev in ("cuda", "cpu"):
        fs = FeatureService.build("f", fraud_view(), num_keys=256,
                                  sharded=True, num_shards=4, device=dev,
                                  capacity=64, num_buckets=512, bucket_size=64)
        fs.store.ingest(dict(hist))
        svc = ScoringService(fs, model.to(dev), torch.as_tensor(table, device=dev))
        req = {c: v[:512].copy() for c, v in
               fraud_transactions(np.random.default_rng(15), 512, 256,
                                  20_000, 20_600).items()}
        before = kernels.LAUNCHES["signature_embed"]
        scores[dev] = svc.handle(req)
        if dev == "cuda":
            assert kernels.LAUNCHES["signature_embed"] == before + 1
    np.testing.assert_allclose(scores["cuda"], scores["cpu"], atol=1e-4)


def _wkv_case(dev, shape, seed, lw_edge=None, layout="bhtd"):
    """(r, k, v, lw, u, s0) on ``dev``, scaled as the reference's kernel
    tests scale them; ``lw_edge`` puts lw above 0, below the floor, at 0
    or a whole chunk at the floor.  ``layout="bthd"`` gives r, k, v, lw as
    the model hands them over: (B, T, H, D) tensors viewed as (B, H, T,
    D)."""
    B, H, T, D = shape
    g = torch.Generator().manual_seed(seed)
    made = (B, T, H, D) if layout == "bthd" else shape
    r = torch.randn(made, generator=g) * 0.5
    k = torch.randn(made, generator=g) * 0.5
    v = torch.randn(made, generator=g)
    lw = -torch.exp(torch.randn(made, generator=g) - 1.0)
    if layout == "bthd":
        r, k, v, lw = (x.transpose(1, 2) for x in (r, k, v, lw))
    if lw_edge == "positive":
        lw[..., ::3] = torch.rand(lw[..., ::3].shape, generator=g) * 2.0
    elif lw_edge == "below_floor":
        lw[..., 1::3] = -3.6 - 16.0 * torch.rand(lw[..., 1::3].shape, generator=g)
    elif lw_edge == "zero":
        lw.zero_()
    elif lw_edge == "chunk_at_floor":
        lw[:, :, 16:32] = LOG_W_MIN
    u = torch.randn((H, D), generator=g) * 0.3
    s0 = torch.randn((B, H, D, D), generator=g) * 0.1
    return [x.to(dev) for x in (r, k, v, lw, u, s0)]


# every head dim the kernel is built for, and 48 (zero-padded to 64), at
# sequence lengths on both sides of a chunk: T < 16 runs "step", T >= 16
# "chunk"
WKV_DIMS = (16, 32, 48, 64, 128, 256)
WKV_LENGTHS = (1, 2, 15, 16, 17, 100, 1024)


@pytest.mark.parametrize("shape,with_s0,edge,layout", [
    *[((2, 2, T, D), True, None, "bhtd") for D in WKV_DIMS
      for T in WKV_LENGTHS],
    # the model's (B, T, H, D) views, prefill and decode
    ((2, 3, 100, 64), True, None, "bthd"),
    ((2, 3, 1, 64), True, None, "bthd"),
    ((2, 3, 15, 48), True, None, "bthd"),
    ((2, 3, 1, 64), False, None, "bhtd"),       # a decode step, zero state
    ((1, 2, 100, 64), False, None, "bhtd"),
    ((1, 2, 48, 64), True, "positive", "bhtd"),
    ((1, 2, 48, 64), True, "below_floor", "bhtd"),
    ((1, 2, 48, 64), True, "zero", "bhtd"),
    ((1, 2, 48, 64), True, "chunk_at_floor", "bhtd"),
    ((1, 2, 15, 64), True, "below_floor", "bhtd"),
])
def test_wkv6_kernel_matches_plain_versions(cuda, shape, with_s0, edge,
                                            layout):
    r, k, v, lw, u, s0 = _wkv_case(cuda, shape, sum(shape), edge, layout)
    s0 = s0 if with_s0 else None
    plan = plan_wkv6(r, k, v, lw)
    assert plan.variant == ("step" if shape[2] < 16 else "chunk")
    assert plan.copy == (shape[3] == 48,) * 4  # the model's views go in as they are
    kernels.reset_launches()
    y, s = wkv6(r, k, v, lw, u, s0)
    assert kernels.LAUNCHES["wkv6"] == 1
    assert kernels.VARIANT_LAUNCHES["wkv6"][plan.variant] == 1
    yc, sc = wkv6_chunked(r, k, v, lw, u, s0)
    yr, sr = wkv6_ref(r, k, v, lw, u, s0)
    torch.cuda.synchronize()
    assert y.shape == shape and s.shape == shape[:2] + (shape[3], shape[3])
    if not any(plan.copy):
        assert y.stride() == r.stride()  # y written in the caller's layout
    for got, want, tol in ((y, yc, 1e-4), (s, sc, 1e-4), (y, yr, 5e-4),
                           (s, sr, 5e-4)):
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("D", [288, 512, 1000])
@pytest.mark.parametrize("T", [1, 16, 100])
@pytest.mark.parametrize("layout", ["bhtd", "bthd"])
def test_wkv6_kernel_wide_head_dims(cuda, D, T, layout):
    """Head dims above 256 run "wide" at any T (decode, one chunk, a
    ragged sequence), on contiguous inputs and the model's views: within
    1e-4 of the chunked plain version, one launch, no copy."""
    r, k, v, lw, u, s0 = _wkv_case(cuda, (1, 2, T, D), D + T, None, layout)
    plan = plan_wkv6(r, k, v, lw)
    assert plan.variant == "wide" and plan.head_dim == D
    assert plan.copy == (False,) * 4
    kernels.reset_launches()
    y, s = wkv6(r, k, v, lw, u, s0)
    assert kernels.VARIANT_LAUNCHES["wkv6"]["wide"] == 1
    assert kernels.LAUNCHES["wkv6"] == 1
    yc, sc = wkv6_chunked(r, k, v, lw, u, s0)
    torch.cuda.synchronize()
    assert y.stride() == r.stride()
    torch.testing.assert_close(y, yc, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, sc, atol=1e-4, rtol=1e-4)


def test_wkv6_kernel_dtypes_and_refusals(cuda):
    r, k, v, lw, u, s0 = _wkv_case(cuda, (1, 2, 20, 64), 5)
    y, s = wkv6(r.bfloat16(), k, v, lw, u, s0)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    yc, _ = wkv6_chunked(r.bfloat16(), k, v, lw, u, s0)
    torch.testing.assert_close(y.float(), yc.float(), atol=2e-2, rtol=2e-2)
    # a transposed (non-contiguous) view goes in as it is
    rt = r.transpose(1, 2).contiguous().transpose(1, 2)
    y2, _ = wkv6(rt, k, v, lw, u, s0)
    y1, _ = wkv6(r, k, v, lw, u, s0)
    assert torch.equal(y1, y2)
    # D = 48 is zero-padded to 64 and computed
    r48, k48, v48, lw48, u48, s48 = _wkv_case(cuda, (1, 2, 20, 48), 5)
    y48, st48 = wkv6(r48, k48, v48, lw48, u48, s48)
    yc48, sc48 = wkv6_chunked(r48, k48, v48, lw48, u48, s48)
    torch.testing.assert_close(y48, yc48, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(st48, sc48, atol=1e-4, rtol=1e-4)
    # a view cp.async cannot take (a 4-byte offset base) is copied
    base = torch.randn((1, 2, 20, 65), device=cuda)
    plan = plan_wkv6(base[..., 1:], k, v, lw)
    assert plan.copy == (True, False, False, False)
    y3, _ = wkv6(base[..., 1:], k, v, lw, u, s0)
    torch.testing.assert_close(
        y3, wkv6_chunked(base[..., 1:], k, v, lw, u, s0)[0], atol=1e-4,
        rtol=1e-4)
    # D above 256 runs "wide" (it raised before)
    r272, k272, v272, lw272, u272, s272 = _wkv_case(cuda, (1, 2, 20, 272), 5)
    y272, st272 = wkv6(r272, k272, v272, lw272, u272, s272)
    yc272, sc272 = wkv6_chunked(r272, k272, v272, lw272, u272, s272)
    torch.testing.assert_close(y272, yc272, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(st272, sc272, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="mixed devices"):
        wkv6(r, k, v, lw, u.cpu(), s0)
    with pytest.raises(NotImplementedError, match="training slice"):
        wkv6(r.requires_grad_(), k, v, lw, u, s0)
    out = torch.empty_like(r.detach()), torch.empty_like(s0)
    launch_wkv6(r.detach(), k, v, lw, u, None, *out)  # zero state from null
    torch.cuda.synchronize()
    torch.testing.assert_close(out[0], wkv6_chunked(r.detach(), k, v, lw, u)[0],
                               atol=1e-4, rtol=1e-4)
    with pytest.raises(RuntimeError, match="launch failed"):
        launch_wkv6(r48, k48, v48, lw48, u48, None, *out)  # no D = 48 build


def test_time_mix_hands_b7_its_views_without_copies(cuda, monkeypatch):
    """``_time_mix`` on the card: B7 launches on the very (B, S, H, 64)
    projections the model made, viewed as (B, H, S, 64) -- no copy of r,
    k, v or lw -- and y comes back as a view whose (B, S, H, 64) order is
    contiguous, in prefill ("chunk") and in a decode step ("step")."""
    from repro_torch.configs.rwkv6_3b import smoke_config
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.models import rwkv6 as rwkv_mod

    calls = []
    real_wkv6, real_launch = rwkv_mod.wkv6, wkv_ops.launch_wkv6

    def spy_wkv6(r, k, v, lw, u, s0=None):
        calls.append({"given": [(x.data_ptr(), x.stride()) for x in (r, k, v, lw)]})
        y, s = real_wkv6(r, k, v, lw, u, s0)
        calls[-1]["y"] = y
        return y, s

    def spy_launch(r, k, v, lw, u, s0, y, s_out):
        calls[-1]["launched"] = [(x.data_ptr(), x.stride()) for x in (r, k, v, lw)]
        calls[-1]["y_launched"] = y.data_ptr()
        return real_launch(r, k, v, lw, u, s0, y, s_out)

    monkeypatch.setattr(rwkv_mod, "wkv6", spy_wkv6)
    monkeypatch.setattr(wkv_ops, "launch_wkv6", spy_launch)
    cfg = smoke_config()
    model = rwkv_mod.RWKV6LM(cfg, seed=3, device="cuda")
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab, (2, 37), generator=g, dtype=torch.int32)
    kernels.reset_launches()
    _, state = model.prefill({"tokens": tokens.to(cuda)})
    model.decode_step(state, tokens[:, :1].to(cuda))
    assert kernels.VARIANT_LAUNCHES["wkv6"] == {"chunk": cfg.n_layers,
                                                "step": cfg.n_layers,
                                                "wide": 0}
    assert len(calls) == 2 * cfg.n_layers
    for c in calls:
        assert c["launched"] == c["given"]
        assert c["y"].data_ptr() == c["y_launched"]
        assert c["y"].transpose(1, 2).is_contiguous()
    S = tokens.shape[1]
    assert calls[0]["given"][0][1][2] == cfg.d_model  # a row of (B, S, H, 64)
    assert calls[0]["y"].shape[2] == S


def test_rwkv6_on_gpu_matches_cpu(cuda):
    """The smoke-width RWKV6 (float32, random mu / u / w0) on the card —
    one WKV6 launch per layer per call — against the same weights on the
    CPU: prefill, then three decode steps."""
    import copy

    from repro_torch.configs.rwkv6_3b import smoke_config
    from repro_torch.models.rwkv6 import RWKV6LM

    cfg = smoke_config()
    gpu = RWKV6LM(cfg, seed=2, device="cuda")
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for lp in gpu.layers:
            for p in (lp["tm"]["mu"], lp["cm"]["mu"]):
                p.copy_(torch.rand(p.shape, generator=g))
            lp["tm"]["u"].copy_(torch.randn(lp["tm"]["u"].shape, generator=g) * 0.5)
            lp["tm"]["w0"].copy_(torch.randn(lp["tm"]["w0"].shape, generator=g) - 0.5)
    cpu = copy.deepcopy(gpu).to("cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 37), generator=g, dtype=torch.int32)
    before = kernels.LAUNCHES["wkv6"]
    lg, sg = gpu.prefill({"tokens": tokens.to(cuda)})
    assert kernels.LAUNCHES["wkv6"] == before + cfg.n_layers
    lc, sc = cpu.prefill({"tokens": tokens})
    for step in range(4):
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-3, rtol=1e-3)
        for name in sc:
            torch.testing.assert_close(sg[name].cpu(), sc[name], atol=1e-3,
                                       rtol=1e-3)
        if step == 3:
            break
        tok = torch.randint(0, cfg.vocab, (2, 1), generator=g, dtype=torch.int32)
        before = kernels.LAUNCHES["wkv6"]
        lg, sg = gpu.decode_step(sg, tok.to(cuda))
        assert kernels.LAUNCHES["wkv6"] == before + cfg.n_layers
        lc, sc = cpu.decode_step(sc, tok)


# B, H, Hkv, S, D, causal, window: the reference's six shapes
# (tests/test_kernels.py), GQA 6:1 (nemotron-4-15b's grouping), D = 96
# (phi3), one row past a tile, the window wider than the sequence
FA_SHAPES = [
    (2, 4, 2, 256, 64, True, None),
    (1, 8, 8, 128, 128, True, 64),
    (2, 4, 1, 192, 80, False, None),
    (1, 2, 2, 100, 32, True, 32),
    (2, 16, 4, 128, 128, True, None),
    (1, 4, 4, 384, 64, True, 128),
    (2, 12, 2, 200, 128, True, None),
    (2, 4, 4, 130, 96, True, None),
    (3, 2, 1, 65, 64, True, None),
    (1, 6, 2, 150, 128, False, 1000),
]


def _fa_case(dev, B, H, Hkv, S, D, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((B, h, S, D), generator=g).to(dev, dtype)
            for h in (H, Hkv, Hkv)]


def _fa_tol(dtype):
    return 2e-5 if dtype == torch.float32 else 3e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window", FA_SHAPES)
def test_flash_attention_kernel_matches_ref(cuda, B, H, Hkv, S, D, causal,
                                            window, dtype):
    q, k, v = _fa_case(cuda, B, H, Hkv, S, D, dtype, B + H + S + D)
    before = kernels.LAUNCHES["flash_attention"]
    out = attention(q, k, v, causal=causal, window=window)
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    want = attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    tol = _fa_tol(dtype)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 65, 100, 129])
@pytest.mark.parametrize("D", [32, 64, 80, 96, 128, 160, 256])
def test_flash_attention_kernel_head_dims(cuda, D, S, dtype):
    """Every head-dim tile of every instantiation: bf16 S <= 128 runs
    "mma16", S = 129 "wgmma", float32 "simt"; a window on odd D."""
    window = 40 if D % 32 else None
    q, k, v = _fa_case(cuda, 2, 4, 2, S, D, dtype, D + S)
    variant = plan_attention(q, k, v).variant
    assert variant == ("simt" if dtype == torch.float32
                       else "mma16" if S <= 128 else "wgmma")
    kernels.reset_launches()
    out = attention(q, k, v, window=window)
    assert kernels.VARIANT_LAUNCHES["flash_attention"][variant] == 1
    assert kernels.LAUNCHES["flash_attention"] == 1
    want = attention_ref(q, k, v, window=window)
    torch.cuda.synchronize()
    tol = _fa_tol(dtype)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,S,window", [
    (288, 100, None), (320, 65, 30), (512, 300, None), (1000, 77, 50),
])
def test_flash_attention_kernel_wide_head_dims(cuda, D, S, window, dtype):
    """Head dims above 256 ("wide": the output's columns split across
    blocks, the scores summed over 128-column slices of D), causal and
    windowed, GQA, and a (B, S, H, D) transposed view."""
    q, k, v = _fa_case(cuda, 2, 4, 2, S, D, dtype, D + S)
    plan = plan_attention(q, k, v)
    assert plan.variant == "wide" and not any(plan.copy)
    kernels.reset_launches()
    out = attention(q, k, v, window=window)
    assert kernels.VARIANT_LAUNCHES["flash_attention"]["wide"] == 1
    assert kernels.LAUNCHES["flash_attention"] == 1
    want = attention_ref(q, k, v, window=window)
    tol = _fa_tol(dtype)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    qt, kt, vt = (x.transpose(1, 2).contiguous().transpose(1, 2)
                  for x in (q, k, v))
    out_t = attention(qt, kt, vt, causal=False, window=window)
    assert out_t.stride() == qt.stride()
    want = attention_ref(q, k, v, causal=False, window=window)
    torch.testing.assert_close(out_t.float(), want.float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_strides_scale_and_refusals(cuda, dtype):
    # (B, S, H, D) activations passed as transposed views: no copy, the
    # output in the same layout
    tol = _fa_tol(dtype)
    g = torch.Generator().manual_seed(3)
    for S in (90, 300):  # both bf16 instantiations
        x = [torch.randn((2, S, h, 64), generator=g).to(cuda, dtype)
             for h in (6, 3, 3)]
        q, k, v = (t.transpose(1, 2) for t in x)
        assert not any(plan_attention(q, k, v).copy)
        out = attention(q, k, v, window=40)
        assert out.stride() == q.stride()
        want = attention_ref(*(t.contiguous() for t in (q, k, v)), window=40)
        torch.testing.assert_close(out.float(), want.float(), atol=tol,
                                   rtol=tol)
        for kw in (dict(scale=0.2), dict(causal=False, window=0),
                   dict(window=-5), dict(window=0),
                   dict(causal=False, window=S + 50)):
            torch.testing.assert_close(attention(q, k, v, **kw).float(),
                                       attention_ref(q, k, v, **kw).float(),
                                       atol=tol, rtol=tol)
        assert not attention(q, k, v, window=0).any()  # every key masked
    # a view TMA cannot take (odd strides) is copied; an odd D is padded
    base = torch.randn((1, 4, 200, 100), generator=g).to(cuda, dtype)
    q = k = v = base[..., :64]
    torch.testing.assert_close(attention(q, k, v).float(),
                               attention_ref(q, k, v).float(), atol=tol,
                               rtol=tol)
    q = k = v = base[..., :100].contiguous()
    torch.testing.assert_close(attention(q, k, v).float(),
                               attention_ref(q, k, v).float(), atol=tol,
                               rtol=tol)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        attention(q, k.to(torch.float64), v)
    with pytest.raises(ValueError, match="mixed devices"):
        attention(q, k.cpu(), v)
    with pytest.raises(NotImplementedError, match="no backward"):
        attention(q.detach().requires_grad_(), k, v)
    q, k, v = (t.transpose(1, 2) for t in x)
    o = torch.empty_like(q)
    before = kernels.LAUNCHES["flash_attention"]
    launch_flash_attention(q, k, v, o, causal=True, window=None, scale=0.125)
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), attention_ref(q, k, v).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,window", [
    ("float32", None), ("float32", 8), ("bfloat16", None),
])
def test_decoder_lm_on_gpu_matches_cpu(cuda, dtype, window):
    """nemotron-4-15b's smoke config on the card -- B6 once per layer per
    prefill, none in decode -- against the same weights on the CPU:
    prefill over 40 tokens, then three decode steps (the ring of 8 wraps
    when ``window`` is set)."""
    import copy

    from repro_torch.configs.nemotron_4_15b import smoke_config
    from repro_torch.models.transformer import DecoderLM

    cfg = smoke_config().replace(param_dtype=dtype, compute_dtype=dtype,
                                 sliding_window=window)
    gpu = DecoderLM(cfg, seed=2, device="cuda")
    cpu = copy.deepcopy(gpu).to("cpu")
    g = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (2, 40), generator=g, dtype=torch.int32)

    def check(got, want):
        if dtype == "float32":
            torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=1e-3)
        else:
            tol = 8 * 2.0 ** -8 * float(want.float().abs().max())
            torch.testing.assert_close(got.cpu().float(), want.float(),
                                       atol=tol, rtol=0)

    before = kernels.LAUNCHES["flash_attention"]
    lg, cg = gpu.prefill({"tokens": tokens.to(cuda)}, max_len=44)
    assert kernels.LAUNCHES["flash_attention"] == before + cfg.n_layers
    lc, cc = cpu.prefill({"tokens": tokens}, max_len=44)
    for step in range(4):
        check(lg, lc)
        check(cg.k, cc.k)
        check(cg.v, cc.v)
        assert torch.equal(cg.pos.cpu(), cc.pos)
        if step == 3:
            break
        tok = torch.randint(0, cfg.vocab, (2, 1), generator=g, dtype=torch.int32)
        before = kernels.LAUNCHES["flash_attention"]
        lg, cg = gpu.decode_step(cg, tok.to(cuda))
        assert kernels.LAUNCHES["flash_attention"] == before
        lc, cc = cpu.decode_step(cc, tok)
