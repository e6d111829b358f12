"""The hand-written CUDA kernels against their plain PyTorch versions.

These tests need an NVIDIA GPU and the CUDA toolkit (the kernels are
built with ``nvcc`` at first use); without a card they skip.  Run them on
the GPU with ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_kernels_cuda.py``.  This file imports neither ``jax`` nor
the JAX package, so it runs where only PyTorch is installed.

Tolerances: the ingest, route and fold-levels kernels must equal their
plain versions exactly — the ingest kernel on all six state arrays (f32
compared as int32 bit patterns), the route kernel on ranks and counts
(integers; from keys also on local ids, shard ids and valid counts, and
the ids equal the host permutation's), the fold-levels kernel on every
level (NaN payloads and
``±0.0`` included).  The window-stats kernel's count, min and max are
exact; its sum and sumsq reduce in the kernel's fixed order, within
``rtol=1e-5, atol=1e-3`` of the plain version and bit for bit equal to
the numpy replay of the kernel (``tests/window_stats_replay.py``).  The signature-embedding kernel equals its
plain version bit for bit (float32 and bfloat16 tables; from
signatures, ``multi_hash_ids`` + the plain version).  The WKV6
kernel is held to its chunked plain version at ``atol = rtol = 1e-4`` and
to the recurrence at ``5e-4`` (float32 products summed in another order);
``RWKV6LM`` on the card to the same model on the CPU at ``1e-3`` on
logits and states (float32 smoke model; cuBLAS and the CPU's BLAS sum in
different orders, over two layers and three decode steps).  The flash
attention kernel is held to its plain version at the reference's
``atol = rtol = 2e-5`` (float32) and ``3e-2`` (bf16); its backward kernel
to ``attention_bwd_ref`` within ``1e-4`` of each gradient's largest
|value| (+ ``1e-6``) in float32 (the same formulas, its products 3xTF32
on the tensor cores and summed in another order) and at ``atol = rtol =
3e-2`` in bf16, and two runs give the same bits;
the forward's lse to ``attention_lse_ref`` within ``1e-4``, with the
output's bits the same whether lse is written or not;
B7's backward kernels to ``wkv6_bwd_ref`` within ``1e-4`` of each
gradient's largest |value| (+ ``1e-6``; float32, the products in 3xTF32,
dlw from suffix sums), two runs the same bits, and ``wkv6`` under autograd to
``wkv6_bwd`` bit for bit;
``DecoderLM`` on the
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
    attention_bwd,
    attention_with_lse,
    launch_flash_attention,
    plan_attention,
    plan_attention_bwd,
)
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref,
    attention_lse_ref,
    attention_ref,
)
from repro_torch.kernels.ingest.ops import fused_ingest
from repro_torch.kernels.ingest.ref import fused_ingest_ref
from repro_torch.core.hashing import KeyPermutation
from repro_torch.core.signature import multi_hash_ids
from repro_torch.kernels.route.ops import route_keys, route_rank
from repro_torch.kernels.signature.ops import (
    launch_signature_embed,
    signature_embed,
)
from repro_torch.kernels.signature.ref import signature_embed_ref
from repro_torch.kernels.route.ref import route_keys_ref, route_rank_ref
from repro_torch.kernels.window_agg.ops import fold_levels, window_stats
from repro_torch.kernels.window_agg.ref import (
    fold_levels_ref,
    fold_num_levels,
    window_stats_ref,
)
from repro_torch.kernels.wkv6.ops import (
    bwd_schedule,
    launch_wkv6,
    launch_wkv6_bwd,
    plan_wkv6,
    plan_wkv6_bwd,
    wkv6,
    wkv6_bwd,
    wkv6_chunked,
)
from repro_torch.kernels.wkv6.ref import LOG_W_MIN, wkv6_bwd_ref, wkv6_ref

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


def _route_keys_case(cuda, n, num_shards, upper, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, upper, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    return (keys, torch.as_tensor(keys, device=cuda),
            torch.as_tensor(valid, device=cuda))


def _assert_route_keys(cuda, keys, k, v, perm, num_shards):
    before = kernels.LAUNCHES["route_rank"]
    got = route_keys(k, v, perm, num_shards=num_shards)
    assert kernels.LAUNCHES["route_rank"] == before + 1
    want = route_keys_ref(k, v, perm, num_shards)
    torch.cuda.synchronize()
    for name, a, b in zip(("local", "shard", "rank", "counts", "valid counts"),
                          got, want):
        assert torch.equal(a, b), name
    inside = (keys >= 0) & (keys < perm.upper)
    routed = perm(keys[inside])
    np.testing.assert_array_equal(got[1].cpu().numpy()[inside],
                                  routed % num_shards)
    np.testing.assert_array_equal(got[0].cpu().numpy()[inside],
                                  routed // num_shards)


@pytest.mark.parametrize("upper", [200, 1 << 19])
@pytest.mark.parametrize("num_shards", [1, 8, 64])
@pytest.mark.parametrize("n", [1, 31, 1024, 1025, 4096, 10_000, 65_536])
def test_route_keys_kernel_matches_plain(cuda, n, num_shards, upper):
    """The Feistel walk and the rank in one launch: the five outputs equal
    the plain composition's exactly, the ids the host permutation's.  The
    200-key domain (size 256) walks long; 2^19 + the valid mask is the
    main path's."""
    keys, k, v = _route_keys_case(cuda, n, num_shards, upper,
                                  n + num_shards + upper)
    _assert_route_keys(cuda, keys, k, v, KeyPermutation(upper), num_shards)


def test_route_keys_kernel_edges(cuda):
    """Keys outside the domain count nowhere; every row on one shard; a
    batch spread over several tiles a block (more tiles than resident
    blocks); an empty batch."""
    perm = KeyPermutation(1 << 19)
    keys = np.random.default_rng(3).integers(0, 1 << 19, 5000).astype(np.int32)
    keys[[0, 17, 4999]] = [-1, 1 << 19, 2**31 - 1]
    _assert_route_keys(cuda, keys, torch.as_tensor(keys, device=cuda),
                       torch.ones(5000, dtype=torch.bool, device=cuda), perm, 8)
    pool = np.arange(1 << 15, dtype=np.int32)
    one = pool[perm(pool) % 8 == 3][:3000]
    got = route_keys(torch.as_tensor(one, device=cuda),
                     torch.ones(3000, dtype=torch.bool, device=cuda), perm,
                     num_shards=8)
    assert torch.equal(got[2].cpu(), torch.arange(3000, dtype=torch.int32))
    assert got[3].cpu().tolist() == [0, 0, 0, 3000, 0, 0, 0, 0]
    keys, k, v = _route_keys_case(cuda, 700_000, 8, 1 << 19, 9)
    _assert_route_keys(cuda, keys, k, v, perm, 8)
    shard = torch.as_tensor(
        np.random.default_rng(4).integers(-1, 9, 700_000).astype(np.int32),
        device=cuda)
    rk, ck = route_rank(shard, num_shards=8)
    rr, cr = route_rank_ref(shard, 8)
    assert torch.equal(rk, rr) and torch.equal(ck, cr)
    empty = torch.empty(0, dtype=torch.int32, device=cuda)
    got = route_keys(empty, empty.bool(), perm, num_shards=8)
    assert got[3].cpu().tolist() == [0] * 8 and got[0].numel() == 0


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


@pytest.mark.parametrize("hash_routing", [False, True])
def test_multitable_store_device_host_single_on_gpu(cuda, hash_routing):
    """A small multi-table sharded store on the card: the device-routed
    path launches B2 once a dispatch — from shard ids under modulo
    routing, from keys under hash routing — and its answers equal, bit for
    bit, the host-routed path's and a single-device store's, with equal
    per-shard counts; a strided batch (all accounts = 0 mod 8) overflows
    the optimistic grid and stays equal."""
    from repro_torch.core.online import OnlineFeatureStore
    from repro_torch.core.shard import ShardedOnlineStore
    from repro_torch.data.synthetic import multitable_stream
    from repro_torch.scenarios import sharded_view

    accounts, merchants = 4096, 256
    kw = dict(num_keys=accounts, capacity=64, num_buckets=512,
              bucket_size=64, secondary_num_keys={"merchants": merchants},
              device="cuda")
    store = ShardedOnlineStore(sharded_view(), num_shards=8,
                               hash_routing=hash_routing, **kw)
    single = OnlineFeatureStore(sharded_view(), **kw)
    rng = np.random.default_rng(12)
    tables = multitable_stream(rng, 20_000, num_accounts=accounts,
                               num_merchants=merchants, t_max=20_000)
    for t, kc in (("accounts", "account"), ("merchants", "merchant"),
                  ("wires", "account"), ("transactions", "account")):
        cols = tables[t]
        o = np.lexsort((cols["ts"], cols[kc]))
        for s in (store, single):
            s.ingest_table(t, {c: v[o] for c, v in cols.items()})
    variant = "keys" if hash_routing else "shards"
    for strided in (False, False, True):
        n = 1000
        req = dict(
            account=rng.integers(0, accounts, n).astype(np.int32),
            ts=np.full(n, 20_100, np.int32),
            amount=rng.gamma(1.5, 60.0, n).astype(np.float32),
            merchant=rng.integers(0, merchants, n).astype(np.int32),
        )
        if strided:
            req["account"] = (req["account"] // 8 * 8).astype(np.int32)
        store.device_routing = False
        ri_h = {}
        host = store.query(dict(req), route_info=ri_h)
        before = dict(kernels.VARIANT_LAUNCHES["route_rank"])
        store.device_routing = True
        ri_d = {}
        got = store.query(dict(req), route_info=ri_d)
        after = kernels.VARIANT_LAUNCHES["route_rank"]
        assert {v: after[v] - before[v] for v in after} == {
            "keys": int(hash_routing), "shards": int(not hash_routing)}
        one = single.query(dict(req))
        np.testing.assert_array_equal(ri_h["shard_counts"],
                                      ri_d["shard_counts"])
        if strided and not hash_routing:
            assert ri_d["shard_counts"][0] == n
        for f in got:
            g = got[f].cpu().numpy()
            np.testing.assert_array_equal(
                g.view(np.int32), host[f].cpu().numpy().view(np.int32),
                err_msg=f"host {f}")
            np.testing.assert_array_equal(
                g.view(np.int32), one[f].cpu().numpy().view(np.int32),
                err_msg=f"single {f}")


@pytest.mark.parametrize("lane", ["sum", "sumsq", "min", "max"])
@pytest.mark.parametrize("n", [57, 256, 338, 340, 1001])
def test_lane_reduce_is_independent_of_row_position(cuda, lane, n):
    """A row's fold gives the same bits wherever the row sits in the
    batch: the same rows reduced at offsets 0 and 1..3 of a larger batch
    (other row addresses, other 16-byte alignments when n is not a
    multiple of 4)."""
    from repro_torch.core.aggregates import lane_masked_reduce

    gen = torch.Generator(device=cuda).manual_seed(n)
    rows = torch.rand((64, n), generator=gen, device=cuda) * 1000.0
    mask = torch.rand((64, n), generator=gen, device=cuda) < 0.8
    want = lane_masked_reduce(lane, rows, mask, 1)
    for shift in (1, 2, 3):
        pad = torch.zeros((shift, n), device=cuda)
        got = lane_masked_reduce(
            lane, torch.cat([pad, rows]),
            torch.cat([pad.bool(), mask]), 1)[shift:]
        np.testing.assert_array_equal(
            got.cpu().numpy().view(np.int32), want.cpu().numpy().view(np.int32),
            err_msg=f"shift {shift}")


@pytest.mark.parametrize("hash_routing", [False, True])
def test_route_and_query_mixed_batches_on_gpu(cuda, hash_routing):
    """A small three-scenario plane on the card: each mixed batch (pad
    rows masked) is one device-routed dispatch with one B2 launch — from
    keys under hash routing, from shard ids under modulo routing — and
    its answers equal, bit for bit, the host-routed plane's per-scenario
    programs, with equal per-(scenario, shard) counts."""
    from repro_torch.core.scenario import ScenarioPlane
    from repro_torch.data.synthetic import multitable_stream
    from repro_torch.scenarios import multi_scenario_views

    accounts, merchants = 4096, 256
    kw = dict(num_keys=accounts, num_shards=8, capacity=64, num_buckets=512,
              bucket_size=64, secondary_num_keys={"merchants": merchants},
              hash_routing=hash_routing, device="cuda")
    views = multi_scenario_views()
    dev = ScenarioPlane(views, **kw)
    host = ScenarioPlane(views, device_routing=False, **kw)
    rng = np.random.default_rng(13)
    tables = multitable_stream(rng, 20_000, num_accounts=accounts,
                               num_merchants=merchants, t_max=30_000)
    for t, kc in (("accounts", "account"), ("merchants", "merchant"),
                  ("wires", "account"), ("transactions", "account")):
        cols = tables[t]
        o = np.lexsort((cols["ts"], cols[kc]))
        for p in (dev, host):
            p.ingest_table(t, {c: v[o] for c, v in cols.items()})
    names = dev.scenarios
    variant = "keys" if hash_routing else "shards"
    for n in (1000, 4096):
        req = dict(
            account=rng.integers(0, accounts, n).astype(np.int32),
            ts=np.full(n, 30_100, np.int32),
            amount=rng.gamma(1.5, 60.0, n).astype(np.float32),
            merchant=rng.integers(0, merchants, n).astype(np.int32),
        )
        tags = np.array([names[i] for i in rng.integers(0, 3, n)])
        valid = np.ones(n, bool)
        valid[-7:] = False
        for mode in ("naive", "preagg"):
            before = dict(kernels.VARIANT_LAUNCHES["route_rank"])
            ri = {}
            got = dev.query_mixed(dict(req), tags, mode=mode, valid=valid,
                                  route_info=ri)
            after = kernels.VARIANT_LAUNCHES["route_rank"]
            assert {v: after[v] - before[v] for v in after} == {
                "keys": int(hash_routing), "shards": int(not hash_routing)}
            assert kernels.VARIANT_LAUNCHES["route_rank"][variant] > 0
            assert ri["scenario_shard_counts"].sum() == valid.sum()
            for i, s in enumerate(names):
                sel = valid & (tags == s)
                ri_h = {}
                want = host.query(s, {c: v[sel] for c, v in req.items()},
                                  mode=mode, route_info=ri_h)
                np.testing.assert_array_equal(
                    ri["scenario_shard_counts"][i], ri_h["shard_counts"])
                assert sorted(want) == sorted(got[s])
                for f in want:
                    np.testing.assert_array_equal(
                        got[s][f].cpu().numpy().view(np.int32),
                        want[f].cpu().numpy().view(np.int32),
                        err_msg=f"{mode} {s} {f}")


def _plane_state(plane):
    """Every state tensor of a plane's store as host bytes (a replicated
    ring's one copy)."""
    s = plane.store._flat_state()
    ts = [s.ring.ts, s.ring.vals, s.ring.cursor, s.bagg.stats,
          s.bagg.bitmap, s.bagg.bucket, *s.bagg.families().values()]
    for r in s.sec:
        ts += [r.ts, r.vals, r.cursor]
    return [t.contiguous().cpu().numpy().view(np.uint8) for t in ts]


def test_hot_deploy_on_gpu_equals_cold_rebuild(cuda):
    """Live evolution of a small sharded plane on the card: a hot-deployed
    scenario keeps every buffer (``data_ptr``); new derived lanes with a
    capacity grow (ring relaid, bucket lanes re-folded on the device) and
    a Signature lane spliced from a ``BackfillSource`` (B1 re-folds its
    buckets) each equal a cold rebuild + replay bit for bit; a refused
    deploy leaves every state tensor's bytes and buffers unchanged."""
    from repro_torch.core.consistency import replay_rounds
    from repro_torch.core.expr import (
        Col, Hash, Signature, range_window, w_count, w_max, w_mean, w_sum,
    )
    from repro_torch.core.scenario import ScenarioPlane
    from repro_torch.core.view import FeatureView
    from repro_torch.data.synthetic import MULTITABLE_DB, multitable_stream
    from repro_torch.offline import BackfillSource
    from repro_torch.scenarios import multi_scenario_views
    from repro_torch.serve.service import FeatureService

    accounts, merchants = 4096, 256
    kw = dict(num_keys=accounts, capacity=64, num_buckets=512,
              bucket_size=64, secondary_num_keys={"merchants": merchants},
              device="cuda")
    rng = np.random.default_rng(21)
    tables = multitable_stream(rng, 20_000, num_accounts=accounts,
                               num_merchants=merchants, t_max=30_000)

    def warm(plane):
        for t, kc in (("accounts", "account"), ("merchants", "merchant"),
                      ("wires", "account")):
            if t in plane.store._sec_names:
                cols = tables[t]
                o = np.lexsort((cols["ts"], cols[kc]))
                plane.ingest_table(t, {c: v[o] for c, v in cols.items()})
        tx = tables["transactions"]
        for idx in replay_rounds(tx["account"], tx["ts"]):
            o = idx[np.lexsort((tx["ts"][idx], tx["account"][idx]))]
            plane.ingest({c: v[o] for c, v in tx.items()})

    def same(a, b, where):
        for i, (x, y) in enumerate(zip(_plane_state(a), _plane_state(b))):
            assert np.array_equal(x, y), f"{where}: state tensor {i}"

    views = multi_scenario_views()
    svc = FeatureService.build_multi("p", views[:2], sharded=True,
                                     num_shards=4, **kw)
    warm(svc.plane)
    s = svc.plane.store.state
    ptrs = [t.data_ptr() for t in (s.ring.ts, s.ring.vals, s.bagg.stats,
                                   *(r.vals for r in s.sec))]
    assert svc.hot_deploy(views[2]).exact
    s = svc.plane.store.state
    assert [t.data_ptr() for t in (s.ring.ts, s.ring.vals, s.bagg.stats,
                                   *(r.vals for r in s.sec))] == ptrs
    cold = ScenarioPlane(views, num_shards=4, **kw)
    warm(cold)
    same(svc.plane, cold, "hot deploy")
    del svc, cold

    amt, w1h = Col("amount"), range_window(3600, bucket=64)
    va = FeatureView("va", features={
        "out": w_sum(amt, w1h, union=("wires",)), "cnt": w_count(amt, w1h)},
        database=MULTITABLE_DB)
    vb = FeatureView("vb", features={
        "dbl": w_sum(amt * 2.0, w1h), "mx": w_max(amt * 2.0, w1h),
        "big": w_mean(amt > 20.0, w1h)}, database=MULTITABLE_DB)
    hot = ScenarioPlane([va], num_shards=4, **kw)
    warm(hot)
    before = _plane_state(hot)
    s = hot.store.state
    ptrs = [t.data_ptr() for t in (s.ring.ts, s.ring.vals, s.bagg.stats)]
    hashed = FeatureView("vh", features={
        "h": w_count(Hash(Col("merchant"), bits=8), w1h)},
        database=MULTITABLE_DB)
    with pytest.raises(ValueError, match="rebuild"):
        hot.evolve([va, hashed])
    for i, (x, y) in enumerate(zip(before, _plane_state(hot))):
        assert np.array_equal(x, y), f"refused deploy moved state {i}"
    s = hot.store.state
    assert [t.data_ptr() for t in (s.ring.ts, s.ring.vals,
                                   s.bagg.stats)] == ptrs
    rep = hot.evolve([va, vb], capacity=96)
    assert rep.exact and rep.synthesized_lanes, rep.describe()
    cold = ScenarioPlane([va, vb], num_shards=4, **dict(kw, capacity=96))
    warm(cold)
    same(hot, cold, "derived lanes + capacity")
    del hot, cold

    sig = FeatureView("merchant_mix", features={
        "sig_cnt_1h": w_count(Signature((Col("merchant"),), bits=8), w1h)},
        database=MULTITABLE_DB)
    small = dict(kw, capacity=2)
    hot = ScenarioPlane(views[:2], num_shards=4, **small)
    warm(hot)
    b1 = kernels.LAUNCHES["fused_ingest"]
    rep = hot.evolve(views[:2] + [sig], capacity=16,
                     backfill=BackfillSource(MULTITABLE_DB, tables))
    assert rep.exact and rep.backfilled, rep.describe()
    assert kernels.LAUNCHES["fused_ingest"] > b1
    cold = ScenarioPlane(views[:2] + [sig], num_shards=4,
                         **dict(kw, capacity=16))
    warm(cold)
    same(hot, cold, "backfilled Signature lane")


def test_fused_ingest_with_families_matches_split_on_gpu(cuda):
    """The online store's ingest of a family layout on the card —
    ``bucket_families_ingest`` then B1 on the six core arrays — equals
    the split ring + ``bucket_ingest`` pass on the card, every tensor bit
    for bit, through a hot key with more rows than the tail, slot reuse,
    pads and an all-pad batch, then 100 rows of one key in a minute
    (full tails); ``seq`` is the cursor, B1 launches once a batch."""
    rng = np.random.default_rng(3)

    def state():
        return (st.ring_init(K, C, F, cuda),
                pg.bucket_init(K, NB, F, BS, cuda, extreme=True, tail=True))

    (r_k, b_k), (r_s, b_s) = state(), state()
    plan = [(8192, 0, 1500, 0, 0), (8192, 1500, 1900, 150, 100),
            (3000, 1900, 3000, 0, 1096), (0, 3000, 3000, 0, 64),
            (8192, 4000, 5500, 0, 0), (2000, 5500, 5560, 100, 0)]
    for step, (n, lo, hi, hot, pad) in enumerate(plan):
        k, t, v = (torch.as_tensor(x, device=cuda)
                   for x in _batch(rng, n, lo, hi, hot, pad))
        before = kernels.LAUNCHES["fused_ingest"]
        pg.bucket_families_ingest(b_k, k, t, v)
        fused_ingest(r_k.ts, r_k.vals, r_k.cursor, b_k.stats, b_k.bitmap,
                     b_k.bucket, k, t, v, bucket_size=BS)
        assert kernels.LAUNCHES["fused_ingest"] == before + 1
        st.ring_ingest(r_s, k, t, v)
        pg.bucket_ingest(b_s, k, t, v)
        _assert_same(
            [r_k.ts, r_k.vals, r_k.cursor, b_k.stats, b_k.bitmap,
             b_k.bucket, *b_k.families().values()],
            [r_s.ts, r_s.vals, r_s.cursor, b_s.stats, b_s.bitmap,
             b_s.bucket, *b_s.families().values()], f"step {step}")
        assert torch.equal(b_k.seq, r_k.cursor), f"step {step}"
    assert bool(b_k.tvalid.all(-1).any()), "no tail filled"


def _family_view():
    """``sharded_view()`` plus FIRST / LAST / TOPN_FREQ over its 1 h
    window: a layout with both merge-order bucket families."""
    from repro_torch.core.expr import (
        Col, range_window, w_first, w_last, w_topn_freq,
    )
    from repro_torch.core.view import FeatureView
    from repro_torch.scenarios import sharded_view

    base = sharded_view()
    w1h = range_window(3600, bucket=64)
    return FeatureView("families", features={
        **base.features,
        "first_amount_1h": w_first(Col("amount"), w1h),
        "last_amount_1h": w_last(Col("amount"), w1h),
        "top_merchant_1h": w_topn_freq(Col("merchant"), w1h, n=0),
        "second_merchant_1h": w_topn_freq(Col("merchant"), w1h, n=1),
    }, database=base.database)


def test_sharded_family_store_device_equals_host_on_gpu(cuda):
    """A sharded store of a family layout on the card: device-routed
    answers (one B2 launch a query) equal the host-routed ones bit for
    bit in both modes, and the family features equal across the modes;
    the families planned mid-flight on a warm plane (rebuilt from the
    rings on the card) equal a cold plane's."""
    from repro_torch.core.consistency import replay_rounds
    from repro_torch.core.scenario import ScenarioPlane
    from repro_torch.data.synthetic import multitable_stream
    from repro_torch.scenarios import sharded_view

    accounts, merchants = 4096, 256
    kw = dict(num_keys=accounts, num_shards=8, capacity=64, num_buckets=64,
              bucket_size=64, secondary_num_keys={"merchants": merchants},
              device="cuda")
    rng = np.random.default_rng(14)
    tables = multitable_stream(rng, 20_000, num_accounts=accounts,
                               num_merchants=merchants, t_max=20_000)

    def warm(plane):
        for t, kc in (("accounts", "account"), ("merchants", "merchant"),
                      ("wires", "account")):
            cols = tables[t]
            o = np.lexsort((cols["ts"], cols[kc]))
            plane.ingest_table(t, {c: v[o] for c, v in cols.items()})
        tx = tables["transactions"]
        # one row a key a batch: the bucket re-fold's exactness contract
        for idx in replay_rounds(tx["account"], tx["ts"]):
            o = idx[np.lexsort((tx["ts"][idx], tx["account"][idx]))]
            plane.ingest({c: v[o] for c, v in tx.items()})

    fam = _family_view()
    plane = ScenarioPlane([fam], **kw)
    warm(plane)
    store = plane.store
    assert store.state.bagg.tts.shape == (8, accounts // 8, 64, 32)
    req = dict(
        account=rng.integers(0, accounts, 1000).astype(np.int32),
        ts=np.full(1000, 20_100, np.int32),
        amount=rng.gamma(1.5, 60.0, 1000).astype(np.float32),
        merchant=rng.integers(0, merchants, 1000).astype(np.int32),
    )
    got = {}
    for mode in ("naive", "preagg"):
        store.device_routing = False
        host = plane.query(fam.name, dict(req), mode=mode)
        store.device_routing = True
        before = kernels.LAUNCHES["route_rank"]
        got[mode] = plane.query(fam.name, dict(req), mode=mode)
        assert kernels.LAUNCHES["route_rank"] == before + 1
        for f in host:
            np.testing.assert_array_equal(
                got[mode][f].cpu().numpy().view(np.int32),
                host[f].cpu().numpy().view(np.int32), err_msg=f"{mode} {f}")
    for f in ("first_amount_1h", "last_amount_1h", "top_merchant_1h",
              "second_merchant_1h"):
        np.testing.assert_array_equal(got["naive"][f].cpu().numpy(),
                                      got["preagg"][f].cpu().numpy(),
                                      err_msg=f)
    assert (got["preagg"]["second_merchant_1h"] != 0).any()

    hot = ScenarioPlane([sharded_view()], **kw)
    warm(hot)
    rep = hot.evolve([sharded_view(), fam])
    assert rep.exact, rep.describe()
    cold = ScenarioPlane([sharded_view(), fam], **kw)
    warm(cold)
    for i, (x, y) in enumerate(zip(_plane_state(hot), _plane_state(cold))):
        assert np.array_equal(x, y), f"families rebuilt on the card: {i}"


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


def _dense_store(rng):
    """The dense history: an unsharded fraud store of 2^11 cards (ring 256,
    512 buckets of 64 s) after 2^20 transactions over a day, 512 a card."""
    from repro_torch.data.synthetic import fraud_transactions
    from repro_torch.scenarios import fraud_view
    from repro_torch.serve.service import FeatureService

    svc = FeatureService.build(
        "d", fraud_view(), num_keys=1 << 11, capacity=256, num_buckets=512,
        bucket_size=64, device="cuda",
    )
    svc.store.ingest(fraud_transactions(rng, 1 << 20, 1 << 11, 0, 86_400))
    return svc.store


def _extra_lanes(x, lanes, dim):
    """``x`` with lanes appended along ``dim`` (copies of lane 0 scaled by
    3, 5, ...), for lane counts the fraud view does not have."""
    first = x.narrow(dim, 0, 1)
    extra = [first * float(2 * i + 3) for i in range(lanes - x.shape[dim])]
    return torch.cat([x, *extra], dim=dim).contiguous()


# (t_lo, t_hi, dense, windows, lanes): late and early requests on a
# sharded store; requests just after the dense day; NW * L beyond the
# register instantiation (3 windows; 3 lanes; 10 windows: two launches)
_WS_CASES = [
    (30_000, 40_000, False, (3600, 21600), 2),
    (0, 300, False, (3600, 21600), 2),
    (86_400, 86_460, True, (3600, 21600), 2),
    (30_000, 40_000, False, (3600, 21600, 600), 2),
    (86_400, 86_460, True, (3600, 21600), 3),
    (30_000, 40_000, False,
     (60, 300, 600, 900, 1800, 3600, 7200, 10800, 21600, 43200), 1),
]


@pytest.mark.parametrize("t_lo,t_hi,dense,windows,lanes", _WS_CASES)
def test_window_stats_kernel_matches_ref(cuda, t_lo, t_hi, dense, windows,
                                         lanes):
    """On a sharded fraud store's flat state (2 lanes), late and early
    requests, and on the dense day's store; also at NW * L beyond the
    register instantiation: count, min, max exact; sums within rtol 1e-5;
    one launch per plan entry."""
    from repro_torch.kernels.window_agg.ops import plan_window_stats

    rng = np.random.default_rng(t_lo + 3 + len(windows) + lanes)
    if dense:
        store = _dense_store(rng)
        s = store.state
        qk = torch.as_tensor(rng.integers(0, 1 << 11, 4096).astype(np.int32),
                             device=cuda)
    else:
        store = _gpu_store(cuda, rng)
        s = store._flat_state()
        keys = rng.integers(0, 512, 1000)
        shard, local = store._route_ids(keys)
        qk = torch.as_tensor((shard * store.num_keys + local).astype(np.int32),
                             device=cuda)
    Q = qk.shape[0]
    qt = torch.as_tensor(rng.integers(t_lo, t_hi, Q).astype(np.int32),
                         device=cuda)
    ql = torch.as_tensor(rng.gamma(1.5, 60.0, (Q, lanes)).astype(np.float32),
                         device=cuda)
    vals, bstats = s.ring.vals[..., :lanes], s.bagg.stats[:, :, :lanes]
    if lanes > vals.shape[-1]:
        vals = _extra_lanes(s.ring.vals, lanes, 2)
        bstats = _extra_lanes(s.bagg.stats, lanes, 2)
    args = (s.ring.ts, vals.contiguous(), bstats.contiguous(), s.bagg.bucket,
            qk, qt, ql)
    before = kernels.LAUNCHES["window_stats"]
    got = window_stats(*args, windows=windows, bucket_size=64)
    assert kernels.LAUNCHES["window_stats"] == \
        before + len(plan_window_stats(len(windows), lanes))
    want = window_stats_ref(*args, windows=windows, bucket_size=64)
    torch.cuda.synchronize()
    got, want = got.cpu().numpy(), want.cpu().numpy()
    for i in (1, 2, 3):
        np.testing.assert_array_equal(got[..., i].view(np.int32),
                                      want[..., i].view(np.int32))
    for i in (0, 4):
        np.testing.assert_allclose(got[..., i], want[..., i], rtol=1e-5,
                                   atol=1e-3)


@pytest.mark.parametrize("NW,L", [(1, 1), (2, 2), (1, 2), (3, 3), (10, 1)])
def test_window_stats_kernel_equals_replay_bit_for_bit(cuda, NW, L):
    """On a small random state (TS_EMPTY and id -1 slots, bucket ids
    anywhere in the row, timestamps before 0, a ragged C and NB that
    load slot by slot, C and NB that load int4 vectors): all five stats,
    sums included, equal the numpy replay of the kernel
    (tests/window_stats_replay.py) bit for bit."""
    from window_stats_replay import replay_window_stats

    rng = np.random.default_rng(100 * NW + L)
    for K, C, NB in ((6, 128, 64), (5, 70, 37)):
        ts = rng.integers(-400, 3000, (K, C)).astype(np.int32)
        ts[rng.random((K, C)) < 0.15] = -2**31
        vals = rng.gamma(1.5, 60.0, (K, C, L)).astype(np.float32)
        bids = rng.integers(-10, 50, (K, NB)).astype(np.int32)
        bids[rng.random((K, NB)) < 0.15] = -1
        bst = rng.gamma(1.5, 60.0, (K, NB, L, 5)).astype(np.float32)
        bst[..., 1] = rng.integers(0, 9, (K, NB, L))
        qk = rng.integers(0, K, 300).astype(np.int32)
        qt = rng.integers(-100, 3200, 300).astype(np.int32)
        ql = rng.gamma(1.5, 60.0, (300, L)).astype(np.float32)
        windows = (600, 100, 3000, 64, 7, 1000, 2000, 40, 5000, 2**31 - 1)[:NW]
        args = [torch.as_tensor(a, device=cuda)
                for a in (ts, vals, bst, bids, qk, qt, ql)]
        got = window_stats(*args, windows=windows, bucket_size=64)
        want = replay_window_stats(ts, vals, bst, bids, qk, qt, ql, windows,
                                   64)
        np.testing.assert_array_equal(got.cpu().numpy().view(np.int32),
                                      want.view(np.int32))


def test_window_stats_launch_captures_in_a_cuda_graph(cuda):
    """``launch_window_stats`` waits on nothing and copies nothing to the
    card: a CUDA graph captures it, and its replay writes what the eager
    launch wrote."""
    from repro_torch.kernels.window_agg.ops import launch_window_stats

    rng = np.random.default_rng(7)
    store = _gpu_store(cuda, rng)
    s = store._flat_state()
    Q = 1000
    qk = torch.as_tensor(rng.integers(0, s.ring.ts.shape[0], Q)
                         .astype(np.int32), device=cuda)
    qt = torch.as_tensor(rng.integers(30_000, 40_000, Q).astype(np.int32),
                         device=cuda)
    ql = torch.as_tensor(rng.gamma(1.5, 60.0, (Q, 2)).astype(np.float32),
                         device=cuda)
    args = (s.ring.ts, s.ring.vals, s.bagg.stats, s.bagg.bucket, qk, qt, ql)
    want = window_stats(*args, windows=(3600, 21600), bucket_size=64)
    out = torch.full_like(want, float("nan"))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        launch_window_stats(*args, (3600, 21600), out, 64)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


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


@pytest.mark.parametrize("k", [1, 2, 3, 32])
@pytest.mark.parametrize("D", [510, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_signature_embed_from_sig_matches_plain(cuda, dtype, D, k):
    """One launch from the signatures (ids hashed in the kernel) equals
    multi_hash_ids + the plain version bit for bit; negative signatures and
    INT32_MIN (whose abs wraps) included."""
    g = torch.Generator().manual_seed(D + k)
    V = 5000
    table = torch.randn((V, D), generator=g).to(dtype).to(cuda)
    sig = torch.randint(-2**31, 2**31 - 1, (1500,), generator=g,
                        dtype=torch.int64).to(torch.int32)
    sig[:5] = torch.tensor([-2**31, -1, 0, 2**31 - 1, 1], dtype=torch.int32)
    sig = sig.to(cuda)
    w = torch.randn((k,), generator=g).to(cuda)
    before = kernels.LAUNCHES["signature_embed"]
    out = signature_embed(table, sig, w, num_hashes=k)
    assert kernels.LAUNCHES["signature_embed"] == before + 1
    want = signature_embed_ref(table, multi_hash_ids(sig, k, V), w).to(dtype)
    torch.cuda.synchronize()
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(out.view(bits), want.view(bits))


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


def _same_nan_and_close(got, want, tol):
    """NaN where ``want`` has NaN, elsewhere within ``atol = rtol = tol``."""
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    torch.testing.assert_close(got[ok], want[ok], atol=tol, rtol=tol)


@pytest.mark.parametrize("D", [288, 512, 1000])
@pytest.mark.parametrize("T", [1, 16, 100, 256, 1024])
@pytest.mark.parametrize("layout", ["bhtd", "bthd"])
def test_wkv6_kernel_wide_head_dims(cuda, D, T, layout):
    """Head dims above 256: "wide_chunk" from T = 16 up (one chunk, a
    ragged sequence, long ones), "wide_step" below (a decode step), on
    contiguous inputs and the model's views: within 1e-4 of the chunked
    plain version with s0 and without, one launch, no copy, two runs the
    same bits."""
    r, k, v, lw, u, s0 = _wkv_case(cuda, (1, 2, T, D), D + T, None, layout)
    plan = plan_wkv6(r, k, v, lw)
    want = "wide_chunk" if T >= 16 else "wide_step"
    assert plan.variant == want and plan.head_dim == D
    assert plan.copy == (False,) * 4
    for state in (s0, None):
        kernels.reset_launches()
        y, s = wkv6(r, k, v, lw, u, state)
        assert kernels.VARIANT_LAUNCHES["wkv6"][want] == 1
        assert kernels.LAUNCHES["wkv6"] == 1
        yc, sc = wkv6_chunked(r, k, v, lw, u, state)
        y2, s2 = wkv6(r, k, v, lw, u, state)
        torch.cuda.synchronize()
        assert y.stride() == r.stride()
        torch.testing.assert_close(y, yc, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(s, sc, atol=1e-4, rtol=1e-4)
        assert torch.equal(y, y2) and torch.equal(s, s2)


@pytest.mark.parametrize("D,T", [(288, 40), (512, 100), (1000, 33),
                                 (512, 7)])
def test_wkv6_kernel_wide_nan_and_padding(cuda, D, T):
    """A NaN in lw reaches y and the state as in the chunked plain version
    (the rows from it on, then every later chunk); D = 290 is padded to
    292 by the wrapper and to 384 inside "wide_chunk"; above
    ``WIDE_CHUNK_MAX`` "wide_step" runs at any T."""
    r, k, v, lw, u, s0 = _wkv_case(cuda, (1, 2, T, D), D + 7 * T)
    lw[0, 1, T // 3, D // 2] = float("nan")
    y, s = wkv6(r, k, v, lw, u, s0)
    yc, sc = wkv6_chunked(r, k, v, lw, u, s0)
    torch.cuda.synchronize()
    assert torch.isnan(y[0, 1]).any() and not torch.isnan(y[0, 0]).any()
    _same_nan_and_close(y, yc, 1e-4)
    _same_nan_and_close(s, sc, 1e-4)
    r, k, v, lw, u, s0 = _wkv_case(cuda, (1, 2, 50, 290), 290)
    assert plan_wkv6(r, k, v, lw).head_dim == 292
    y, s = wkv6(r, k, v, lw, u, s0)
    yc, sc = wkv6_chunked(r, k, v, lw, u, s0)
    torch.testing.assert_close(y, yc, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, sc, atol=1e-4, rtol=1e-4)
    r, k, v, lw, u, s0 = _wkv_case(cuda, (1, 1, 20, 2056), 9)
    kernels.reset_launches()
    y, s = wkv6(r, k, v, lw, u, s0)
    assert kernels.VARIANT_LAUNCHES["wkv6"]["wide_step"] == 1
    yc, sc = wkv6_chunked(r, k, v, lw, u, s0)
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
    # D above 256 runs "wide_chunk" (it raised before)
    r272, k272, v272, lw272, u272, s272 = _wkv_case(cuda, (1, 2, 20, 272), 5)
    y272, st272 = wkv6(r272, k272, v272, lw272, u272, s272)
    yc272, sc272 = wkv6_chunked(r272, k272, v272, lw272, u272, s272)
    torch.testing.assert_close(y272, yc272, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(st272, sc272, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="mixed devices"):
        wkv6(r, k, v, lw, u.cpu(), s0)
    # under autograd: the forward kernel, then B7's backward kernel
    rg = r.detach().clone().requires_grad_()
    y, _ = wkv6(rg, k, v, lw, u, s0)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(6)).to(cuda)
    y.backward(dy)
    _wkv_bwd_close(rg.grad, wkv6_bwd_ref(r, k, v, lw, u, s0, dy, None)[0])
    # above D = 64 the "wide" backward (it raised before)
    r128, k128, v128, lw128, u128, s128 = _wkv_case(cuda, (1, 2, 20, 128), 5)
    rg128 = r128.detach().clone().requires_grad_()
    y128, _ = wkv6(rg128, k128, v128, lw128, u128, s128)
    dy128 = torch.randn(y128.shape, generator=torch.Generator().manual_seed(7)).to(cuda)
    kernels.reset_launches()
    y128.backward(dy128)
    assert kernels.VARIANT_LAUNCHES["wkv6_bwd"] == _b7_runs(
        {"wide_fwd": 1, "wide_reduce": 1})
    _wkv_bwd_close(rg128.grad, wkv6_bwd_ref(r128, k128, v128, lw128, u128,
                                            s128, dy128, None)[0])
    out = torch.empty_like(r.detach()), torch.empty_like(s0)
    launch_wkv6(r.detach(), k, v, lw, u, None, *out)  # zero state from null
    torch.cuda.synchronize()
    torch.testing.assert_close(out[0], wkv6_chunked(r.detach(), k, v, lw, u)[0],
                               atol=1e-4, rtol=1e-4)
    with pytest.raises(RuntimeError, match="launch failed"):
        launch_wkv6(r48, k48, v48, lw48, u48, None, *out)  # no D = 48 build


def _b7_runs(runs):
    """``runs`` (B7-bwd launches by name) over every launch name, the
    others 0, as ``VARIANT_LAUNCHES["wkv6_bwd"]`` holds them."""
    return {n: runs.get(n, 0) for n in kernels.VARIANT_LAUNCHES["wkv6_bwd"]}


def _wkv_bwd_close(got, want):
    """Within 1e-4 of the gradient's largest |value| + 1e-6 (float32
    formulas summed in another order, the products in 3xTF32; dlw from the
    suffix sums of ``wkv6_bwd.cu``)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    if not want.numel():
        return
    bound = 1e-4 * float(want.abs().max()) + 1e-6
    assert float((got - want).abs().max()) <= bound


# (B, H, T, D), s0, ds_fin, lw edge, layout: the training shape on the
# model's views, T on both sides of the kernels' 16-row chunks (one and two
# whole chunks, a row past them), D below 64 (zero-padded), the lw edges
WKV_BWD_CASES = [
    ((2, 40, 1024, 64), False, False, None, "bthd"),
    ((2, 40, 1024, 64), True, True, None, "bthd"),
    *[((2, 3, T, 64), True, True, None, "bthd")
      for T in (1, 7, 8, 15, 16, 17, 32, 33, 100)],
    ((2, 3, 0, 64), True, True, None, "bhtd"),
    ((1, 2, 33, 48), True, True, None, "bthd"),
    ((1, 2, 20, 32), False, True, None, "bhtd"),
    ((1, 2, 48, 64), True, True, "positive", "bhtd"),
    ((1, 2, 48, 64), True, True, "below_floor", "bhtd"),
    ((1, 2, 48, 64), True, True, "zero", "bhtd"),
    ((1, 2, 48, 64), True, True, "chunk_at_floor", "bhtd"),
]


@pytest.mark.parametrize("shape,with_s0,with_dsf,edge,layout", WKV_BWD_CASES)
def test_wkv6_bwd_kernel_matches_ref(cuda, shape, with_s0, with_dsf, edge,
                                     layout):
    """B7's backward kernels against ``wkv6_bwd_ref``: the forward and the
    reverse sweep once each; two runs the same bits; the model's views take
    their gradients in their own layout, uncopied; D < 64 padded."""
    r, k, v, lw, u, s0 = _wkv_case(cuda, shape, 3 + sum(shape), edge, layout)
    g = torch.Generator().manual_seed(sum(shape))
    dy = torch.randn(r.shape, generator=g).to(cuda)
    if layout == "bthd":
        dy = dy.transpose(1, 2).contiguous().transpose(1, 2)
    dsf = torch.randn(s0.shape, generator=g).to(cuda) * 0.1 if with_dsf else None
    s0 = s0 if with_s0 else None
    plan = plan_wkv6_bwd(r, k, v, lw, dy)
    assert plan.copy == (shape[3] != 64,) * 5
    kernels.reset_launches()
    got = wkv6_bwd(r, k, v, lw, u, s0, dy, dsf)
    assert kernels.VARIANT_LAUNCHES["wkv6_bwd"] == _b7_runs({"fwd": 1, "rev": 1})
    assert kernels.LAUNCHES["wkv6_bwd"] == 2
    again = wkv6_bwd(r, k, v, lw, u, s0, dy, dsf)
    want = wkv6_bwd_ref(r, k, v, lw, u, s0, dy, dsf)
    torch.cuda.synchronize()
    for x, a, b, w in zip((r, k, v, lw, u, s0), got, again, want):
        if w is None:
            assert a is None
            continue
        assert torch.equal(a, b)
        _wkv_bwd_close(a, w)
        if x.dim() == 4 and not any(plan.copy):
            assert a.stride() == x.stride()


# (dr, dk, dv, dlw, du, ds0) asked for, and the sweeps that launch: each
# gradient alone, and r with v
WKV_BWD_SUBSETS = [
    ((True, False, False, False, False, False), {"fwd": 1, "rev": 0}),
    ((False, True, False, False, False, False), {"fwd": 0, "rev": 1}),
    ((False, False, True, False, False, False), {"fwd": 0, "rev": 1}),
    ((False, False, False, True, False, False), {"fwd": 1, "rev": 1}),
    ((False, False, False, False, True, False), {"fwd": 1, "rev": 0}),
    ((False, False, False, False, False, True), {"fwd": 0, "rev": 1}),
    ((True, False, True, False, False, False), {"fwd": 1, "rev": 1}),
]


@pytest.mark.parametrize("needs,runs", WKV_BWD_SUBSETS)
def test_wkv6_bwd_kernel_gradient_subsets(cuda, needs, runs):
    """B7's backward asked for some gradients only, with s0 and ds_fin over
    several chunks: each one asked for matches ``wkv6_bwd_ref`` whatever
    else is left out (dv without dk, dlw or ds0 reads the dS the reverse
    sweep's rows warps carry), the others are None, and only the sweeps
    that write them launch."""
    r, k, v, lw, u, s0 = _wkv_case(cuda, (2, 3, 70, 64), 17, None, "bthd")
    g = torch.Generator().manual_seed(17)
    dy = torch.randn(r.shape, generator=g).to(cuda)
    dsf = torch.randn(s0.shape, generator=g).to(cuda) * 0.1
    kernels.reset_launches()
    got = wkv6_bwd(r, k, v, lw, u, s0, dy, dsf, needs=needs)
    assert kernels.VARIANT_LAUNCHES["wkv6_bwd"] == _b7_runs(runs)
    want = wkv6_bwd_ref(r, k, v, lw, u, s0, dy, dsf)
    torch.cuda.synchronize()
    for n, a, w in zip(needs, got, want):
        if n:
            _wkv_bwd_close(a, w)
        else:
            assert a is None


# (B, H, T, D): above D = 64 the "wide" backward -- 96, 128, 256, 288,
# 512 and 1,000 (not a multiple of 16: the last column group part zeros),
# T on both sides of a chunk, and D = 2,100 (two channel passes, dv summed)
WKV_BWD_WIDE_CASES = [
    *[((2, 2, T, D), "bthd") for D in (96, 128, 256, 288, 512, 1000)
      for T in (1, 17, 100)],
    ((1, 3, 33, 128), "bhtd"),
    ((1, 1, 20, 2100), "bhtd"),
]


@pytest.mark.parametrize("shape,layout", WKV_BWD_WIDE_CASES)
def test_wkv6_bwd_wide_matches_ref(cuda, shape, layout):
    """B7's "wide" backward (D > 64) against ``wkv6_bwd_ref`` with s0 and
    ds_fin: wide_fwd, wide_rev and wide_reduce once each; two runs the
    same bits; each gradient in its input's layout where it goes in
    uncopied."""
    r, k, v, lw, u, s0 = _wkv_case(cuda, shape, 9 + sum(shape), None, layout)
    g = torch.Generator().manual_seed(sum(shape))
    dy = torch.randn(r.shape, generator=g).to(cuda)
    dsf = torch.randn(s0.shape, generator=g).to(cuda) * 0.1
    plan = plan_wkv6_bwd(r, k, v, lw, dy)
    assert plan.variant == "wide"
    kernels.reset_launches()
    got = wkv6_bwd(r, k, v, lw, u, s0, dy, dsf)
    assert kernels.VARIANT_LAUNCHES["wkv6_bwd"] == _b7_runs(
        {"wide_fwd": 1, "wide_rev": 1, "wide_reduce": 1})
    again = wkv6_bwd(r, k, v, lw, u, s0, dy, dsf)
    want = wkv6_bwd_ref(r, k, v, lw, u, s0, dy, dsf)
    torch.cuda.synchronize()
    for x, a, b, w in zip((r, k, v, lw, u, s0), got, again, want):
        assert torch.equal(a, b)
        _wkv_bwd_close(a, w)
        if x.dim() == 4 and not any(plan.copy):
            assert a.stride() == x.stride()


# (B, H, T, D), value column groups the scratch is given room for: one
# group a batch, uneven batches, and channel passes (dv summed once, after
# the last batch)
WKV_BWD_BATCH_CASES = [((2, 2, 100, 288), 1), ((1, 3, 40, 1000), 7),
                       ((1, 1, 20, 2100), 5)]


@pytest.mark.parametrize("shape,room", WKV_BWD_BATCH_CASES)
def test_wkv6_bwd_wide_group_batches_keep_the_bits(cuda, shape, room):
    """The "wide" backward given scratch for only ``room`` value column
    groups runs them in ⌈G / room⌉ batches (sweeps and sum each batch, as
    the library's ``wkv6_bwd_kernels`` counts them) with the same bits as
    one batch; scratch for less than one group raises."""
    B, H, T, D = shape
    r, k, v, lw, u, s0 = _wkv_case(cuda, shape, 29 + D)
    g = torch.Generator().manual_seed(D)
    dy = torch.randn(r.shape, generator=g).to(cuda)
    dsf = torch.randn(s0.shape, generator=g).to(cuda) * 0.1
    plan = plan_wkv6_bwd(r, k, v, lw, dy)
    assert plan == ("wide", D, (False,) * 5)
    every = (True,) * 6

    def run(floats=None):
        outs = [torch.empty_like(r) for _ in range(4)]
        du, ds0 = r.new_empty((B, H, D)), torch.empty_like(s0)
        launch_wkv6_bwd(r, k, v, lw, dy, u, s0, dsf, *outs, du, ds0,
                        scratch_floats=floats)
        return outs + [du, ds0]

    groups, passes = -(-D // 16), -(-D // 2048)
    n = B * H * T * D
    per_group = 3 * n + B * H * D
    fixed = passes * n if passes > 1 else 0
    kernels.reset_launches()
    whole = run()
    assert kernels.VARIANT_LAUNCHES["wkv6_bwd"] == _b7_runs(
        {"wide_fwd": 1, "wide_rev": 1, "wide_reduce": 1})
    assert bwd_schedule(plan, B, H, T, every)[0] == groups * per_group + fixed
    floats = room * per_group + fixed
    batches = -(-groups // room)
    assert bwd_schedule(plan, B, H, T, every, floats)[1] == {
        "wide_fwd": batches, "wide_rev": batches, "wide_reduce": batches}
    kernels.reset_launches()
    batched = run(floats)
    assert kernels.VARIANT_LAUNCHES["wkv6_bwd"] == _b7_runs(
        {"wide_fwd": batches, "wide_rev": batches, "wide_reduce": batches})
    want = wkv6_bwd_ref(r, k, v, lw, u, s0, dy, dsf)
    torch.cuda.synchronize()
    for a, b, w in zip(whole, batched, want):
        assert torch.equal(a, b)
        _wkv_bwd_close(b if w.dim() != 2 else b.sum(0), w)
    with pytest.raises(ValueError, match="less than one value column group"):
        run(per_group + fixed - 1)


@pytest.mark.parametrize("needs,runs", WKV_BWD_SUBSETS)
def test_wkv6_bwd_wide_gradient_subsets(cuda, needs, runs):
    """The "wide" backward asked for some gradients only (D = 288): each
    one asked for matches ``wkv6_bwd_ref``, the others are None, and only
    the launches it needs run -- the two sweeps as at D = 64, the sum of
    partials where dr, dk, dlw or du is asked for."""
    r, k, v, lw, u, s0 = _wkv_case(cuda, (2, 2, 70, 288), 19, None, "bthd")
    g = torch.Generator().manual_seed(19)
    dy = torch.randn(r.shape, generator=g).to(cuda)
    dsf = torch.randn(s0.shape, generator=g).to(cuda) * 0.1
    kernels.reset_launches()
    got = wkv6_bwd(r, k, v, lw, u, s0, dy, dsf, needs=needs)
    wide = {"wide_" + n: c for n, c in runs.items()}
    wide["wide_reduce"] = int(any(needs[i] for i in (0, 1, 3, 4)))
    assert kernels.VARIANT_LAUNCHES["wkv6_bwd"] == _b7_runs(wide)
    want = wkv6_bwd_ref(r, k, v, lw, u, s0, dy, dsf)
    torch.cuda.synchronize()
    for n, a, w in zip(needs, got, want):
        if n:
            _wkv_bwd_close(a, w)
        else:
            assert a is None


def test_wkv6_autograd_on_the_card(cuda):
    """``wkv6`` under autograd on the model's (B, S, H, 64) views: the
    forward kernel once (the same bits as under no_grad), the backward
    kernels once each (both sweeps), gradients == ``wkv6_bwd``; an unused
    final state brings no gradient (ds_fin None), an unused y none either
    (dy zeros); the forward twice and the backward once under
    ``checkpoint``; only the gradients asked for are computed (du alone:
    the forward sweep only; v alone: the reverse sweep only)."""
    from torch.utils.checkpoint import checkpoint

    r, k, v, lw, u, s0 = _wkv_case(cuda, (2, 4, 70, 64), 21, None, "bthd")
    leaves = [x.detach().clone().requires_grad_() for x in (r, k, v, lw, u, s0)]
    with torch.no_grad():
        plain = wkv6(r, k, v, lw, u, s0)
    kernels.reset_launches()
    y, s_fin = wkv6(*leaves)
    assert kernels.LAUNCHES["wkv6"] == 1 and torch.equal(y, plain[0])
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(2)).to(cuda)
    y.backward(dy)
    assert kernels.VARIANT_LAUNCHES["wkv6_bwd"] == _b7_runs({"fwd": 1, "rev": 1})
    want = wkv6_bwd(r, k, v, lw, u, s0, dy, None)
    for x, w in zip(leaves, want):
        assert torch.equal(x.grad, w)
    # only the final state used: dy comes in as zeros
    for x in leaves:
        x.grad = None
    _, s_fin = wkv6(*leaves)
    dsf = torch.randn(s_fin.shape, generator=torch.Generator().manual_seed(3)).to(cuda)
    s_fin.backward(dsf)
    want = wkv6_bwd(r, k, v, lw, u, s0, torch.zeros_like(r), dsf)
    for x, w in zip(leaves, want):
        assert torch.equal(x.grad, w)
    # rematerialized as RWKV6LM.loss does; u alone asks for a gradient
    kernels.reset_launches()
    ul = u.detach().clone().requires_grad_()
    out = checkpoint(lambda uu: wkv6(r, k, v, lw, uu, None)[0], ul,
                     use_reentrant=False)
    out.backward(dy)
    assert (kernels.LAUNCHES["wkv6"], kernels.LAUNCHES["wkv6_bwd"]) == (2, 1)
    assert kernels.VARIANT_LAUNCHES["wkv6_bwd"] == _b7_runs({"fwd": 1})
    _wkv_bwd_close(ul.grad, wkv6_bwd_ref(r, k, v, lw, u, None, dy, None)[4])
    # v alone asks for a gradient, over five chunks
    kernels.reset_launches()
    vl = v.detach().clone().requires_grad_()
    wkv6(r, k, vl, lw, u, s0)[0].backward(dy)
    assert kernels.VARIANT_LAUNCHES["wkv6_bwd"] == _b7_runs({"rev": 1})
    _wkv_bwd_close(vl.grad, wkv6_bwd_ref(r, k, v, lw, u, s0, dy, None)[2])


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
                                                "wide_chunk": 0,
                                                "wide_step": 0}
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
    "mma16", S = 129 "wgmma", float32 "f32" (3xTF32 on the tensor cores);
    a window on odd D."""
    window = 40 if D % 32 else None
    q, k, v = _fa_case(cuda, 2, 4, 2, S, D, dtype, D + S)
    variant = plan_attention(q, k, v).variant
    assert variant == ("f32" if dtype == torch.float32
                       else "mma16" if S <= 128 else "wgmma")
    kernels.reset_launches()
    out = attention(q, k, v, window=window)
    assert kernels.VARIANT_LAUNCHES["flash_attention"][variant] == 1
    assert kernels.LAUNCHES["flash_attention"] == 1
    want = attention_ref(q, k, v, window=window)
    torch.cuda.synchronize()
    tol = _fa_tol(dtype)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("D", [160, 192, 224, 256, 64, 33])
@pytest.mark.parametrize("S,window", [(100, None), (300, 1000), (70, 20)])
def test_flash_attention_f32_kernel_tiles(cuda, D, S, window):
    """float32 ``"f32"`` (3xTF32 on the tensor cores) at every tile above
    D = 128 -- two warps splitting D's columns over 32-key tiles (160,
    192) and 16-key ones (224, 256) -- and at D = 64 and 33 (padded to 36,
    copied): causal, a window wider than the sequence (every tile inside
    it), a narrow one; GQA 2:1.  Within 2e-5 of ``attention_ref``; two
    runs the same bits; o's bits the same with the lse, the lse within
    1e-4 of ``attention_lse_ref``'s; the model's (B, S, H, D) transposed
    views give the same bits as contiguous inputs, uncopied; a window of 0
    leaves every row without a key: o 0, lse +inf."""
    q, k, v = _fa_case(cuda, 2, 4, 2, S, D, torch.float32, D + S)
    plan = plan_attention(q, k, v)
    assert plan.variant == "f32" and any(plan.copy) == (D % 4 != 0)
    kernels.reset_launches()
    out = attention(q, k, v, window=window)
    assert kernels.VARIANT_LAUNCHES["flash_attention"]["f32"] == 1
    assert kernels.LAUNCHES["flash_attention"] == 1
    want = attention_ref(q, k, v, window=window)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)
    assert torch.equal(out, attention(q, k, v, window=window))
    o2, lse = attention_with_lse(q, k, v, window=window)
    assert torch.equal(out, o2)
    _, want_lse = attention_lse_ref(q, k, v, window=window)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
    qt, kt, vt = (x.transpose(1, 2).contiguous().transpose(1, 2)
                  for x in (q, k, v))
    assert any(plan_attention(qt, kt, vt).copy) == (D % 4 != 0)
    out_t = attention(qt, kt, vt, window=window)
    if D % 4 == 0:
        assert out_t.stride() == qt.stride()
    assert torch.equal(out_t, out)
    o0, lse0 = attention_with_lse(q, k, v, window=0)
    torch.cuda.synchronize()
    assert not o0.any() and bool(torch.isinf(lse0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,S,window", [
    (288, 100, None), (320, 65, 30), (512, 300, None), (1000, 77, 50),
    (512, 1024, None), (1344, 130, None), (1500, 70, 40),
])
def test_flash_attention_kernel_wide_head_dims(cuda, D, S, window, dtype):
    """Head dims above 256 ("wide": bf16 on the tensor cores, the scores'
    D split between two warpgroups and summed once, 512 output columns a
    pass; float32 on the CUDA cores, up to 1,024 columns a pass), causal
    and windowed, GQA, a (B, S, H, D) transposed view, a sequence of
    1,024, bf16 with Q streamed through the ring (D = 1,344), column
    passes (1,344 and 1,500), two runs the same bits."""
    q, k, v = _fa_case(cuda, 2, 4, 2, S, D, dtype, D + S)
    plan = plan_attention(q, k, v)
    assert plan.variant == "wide"
    # bf16 pads D = 1,500 to 1,504 (copied); the others go in as they are
    assert any(plan.copy) == (dtype == torch.bfloat16 and D % 8 != 0)
    kernels.reset_launches()
    out = attention(q, k, v, window=window)
    assert kernels.VARIANT_LAUNCHES["flash_attention"]["wide"] == 1
    assert kernels.LAUNCHES["flash_attention"] == 1
    want = attention_ref(q, k, v, window=window)
    tol = _fa_tol(dtype)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(out, attention(q, k, v, window=window))
    qt, kt, vt = (x.transpose(1, 2).contiguous().transpose(1, 2)
                  for x in (q, k, v))
    out_t = attention(qt, kt, vt, causal=False, window=window)
    if not any(plan.copy):
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
    # the raw launcher on the transposed views, into a strided output
    q, k, v = (t.transpose(1, 2) for t in x)
    o = torch.empty_like(q)
    before = kernels.LAUNCHES["flash_attention"]
    launch_flash_attention(q, k, v, o, causal=True, window=None, scale=0.125)
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), attention_ref(q, k, v).float(),
                               atol=tol, rtol=tol)
    # above D = 256 the "wide" backward (it raised before)
    wide = torch.randn((1, 2, 16, 288), generator=g).to(cuda, dtype)
    leaf = wide.clone().requires_grad_()
    ow = attention(leaf, wide, wide)
    dow = torch.randn(ow.shape, generator=g).to(cuda, dtype)
    ow.backward(dow)
    _fa_bwd_close(leaf.grad, attention_bwd_ref(wide, wide, wide, ow.detach(),
                                               dow)[0], dtype)


# (B, H, Hkv, S, D, causal, window): GQA 1:1, 2:1, 4:1, 6:1 and 16:1,
# not causal, windows, S = 1, 127, 129 and S not a multiple of the 64- or
# 128-row tiles, every head-dim tile (32, 64, 128, 256 in float32; 64, 128,
# 256 in bf16) with D = 32, 48, 80 and 96 inside one (bf16 pads 48 and 80
# to multiples of 16, and 32 / 96 reach the tiles' zero-filled columns)
FA_BWD_SHAPES = [
    (2, 4, 2, 128, 64, True, None),
    (2, 4, 4, 65, 64, False, None),
    (1, 8, 2, 200, 128, True, 64),
    (1, 4, 1, 129, 256, True, 50),
    (1, 16, 1, 127, 32, True, None),
    (2, 2, 2, 1, 64, True, None),
    (1, 4, 2, 130, 96, True, None),
    (1, 2, 1, 100, 48, False, 30),
    (1, 12, 2, 200, 64, False, None),
    (1, 4, 4, 129, 32, False, 40),
    (1, 16, 1, 300, 128, True, None),
    (2, 8, 2, 257, 256, False, None),
    (1, 6, 1, 127, 80, True, 17),
]


def _fa_bwd_close(got, want, dtype):
    """float32: within 1e-4 of the gradient's largest |value| plus 1e-6
    (a gradient that is 0 in exact arithmetic -- dQ and dK at S = 1, where
    dP = Δ -- is rounding noise of O(1) terms in both); bf16: the
    forward's 3e-2."""
    if dtype == torch.float32:
        bound = 1e-4 * float(want.abs().max()) + 1e-6
        assert float((got - want).abs().max()) <= bound
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=3e-2,
                                   rtol=3e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window", FA_BWD_SHAPES)
def test_flash_attention_bwd_kernel_matches_ref(cuda, B, H, Hkv, S, D, causal,
                                                window, dtype):
    """The backward kernel against ``attention_bwd_ref`` on the same q, k,
    v, o (the forward kernel's) and dO, with the forward's lse: bf16
    through the ``wgmma`` variant, float32 through ``f32`` (3xTF32 on the
    tensor cores), each delta, dq, dkdv and, for H > Hkv, the reduce; a
    second run gives the same bits, and so does a call that fetches its
    own lse."""
    q, k, v = _fa_case(cuda, B, H, Hkv, S, D, dtype, 7 * S + D)
    kw = dict(causal=causal, window=window)
    with torch.no_grad():
        o = attention(q, k, v, **kw)
    o_lse, lse = attention_with_lse(q, k, v, **kw)
    assert torch.equal(o_lse, o)
    g = torch.Generator().manual_seed(S + D)
    do = torch.randn(q.shape, generator=g).to(cuda, dtype)
    plan = plan_attention_bwd(q, k, v, o, do)
    assert plan.variant == ("f32" if dtype == torch.float32 else "wgmma")
    assert plan.reduce == (H > Hkv)
    kernels.reset_launches()
    got = attention_bwd(q, k, v, o, do, lse=lse, **kw)
    counts = kernels.VARIANT_LAUNCHES["flash_attention_bwd"]
    assert counts == {n: int(n in plan.launches) for n in counts}
    assert kernels.LAUNCHES["flash_attention"] == 0
    again = attention_bwd(q, k, v, o, do, lse=lse, **kw)
    want = attention_bwd_ref(q, k, v, o, do, **kw)
    runs = [again, attention_bwd(q, k, v, o, do, **kw)]
    torch.cuda.synchronize()
    for i, (a, w, x) in enumerate(zip(got, want, (q, k, v))):
        assert a.shape == x.shape and a.dtype == dtype
        for run in runs:
            assert torch.equal(a, run[i])
        _fa_bwd_close(a, w, dtype)


# (B, H, Hkv, S, D, causal, window) above head dim 256: FA_WIDE_SHAPES'
# head dims -- one column pass, Q streamed (1,344), column passes of dQ
# (1,344, 1,500) and of dK / dV (every one) -- GQA and not, windows
FA_BWD_WIDE_SHAPES = [
    (2, 4, 2, 100, 288, True, None), (2, 4, 2, 65, 320, True, 30),
    (1, 4, 2, 300, 512, True, None), (1, 4, 2, 77, 1000, True, 50),
    (1, 2, 2, 130, 1344, False, None), (1, 4, 1, 70, 1500, True, 40),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window", FA_BWD_WIDE_SHAPES)
def test_flash_attention_bwd_wide_matches_ref(cuda, B, H, Hkv, S, D, causal,
                                              window, dtype):
    """Above head dim 256, the ``"wide"`` backward against
    ``attention_bwd_ref``, both dtypes on the tensor cores with the wide
    forward's lse: bf16 delta, wide_dq, wide_dkdv, float32 (3xTF32)
    f32_delta, f32_wide_dq, f32_wide_dkdv and, for H > Hkv, the reduce;
    each launch once by name; two runs the same bits."""
    q, k, v = _fa_case(cuda, B, H, Hkv, S, D, dtype, 5 * S + D)
    kw = dict(causal=causal, window=window)
    with torch.no_grad():
        o = attention(q, k, v, **kw)
    o_lse, lse = attention_with_lse(q, k, v, **kw)
    assert torch.equal(o_lse, o)
    g = torch.Generator().manual_seed(S + D)
    do = torch.randn(q.shape, generator=g).to(cuda, dtype)
    plan = plan_attention_bwd(q, k, v, o, do)
    assert plan.variant == "wide"
    kernels.reset_launches()
    got = attention_bwd(q, k, v, o, do, lse=lse, **kw)
    counts = kernels.VARIANT_LAUNCHES["flash_attention_bwd"]
    assert counts == {n: int(n in plan.launches) for n in counts}
    again = attention_bwd(q, k, v, o, do, lse=lse, **kw)
    want = attention_bwd_ref(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    for a, b, w, x in zip(got, again, want, (q, k, v)):
        assert a.shape == x.shape and a.dtype == dtype
        assert torch.equal(a, b)
        _fa_bwd_close(a, w, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window", [
    (2, 4, 2, 65, 64, True, None), (1, 8, 2, 129, 128, True, None),
    (1, 4, 1, 300, 256, True, 100), (2, 4, 4, 200, 96, False, None),
    (1, 2, 2, 150, 64, True, -3), (1, 4, 2, 300, 512, True, None),
    (1, 2, 2, 130, 1344, False, 40), (1, 2, 1, 70, 600, True, -3),
])
def test_flash_attention_lse_keeps_the_output_bits(cuda, B, H, Hkv, S, D,
                                                   causal, window, dtype):
    """bf16 ``mma16``, ``wgmma`` and ``wide`` (one column pass, and two at
    D = 1,344), float32 ``f32`` and ``wide`` (two column passes at D =
    1,344): the forward with its lse written gives the same bits of o as
    without; lse equals ``attention_lse_ref``'s within ``1e-4`` (float32
    sums in other orders), +inf on rows that see no key (a window of -3
    hides every key)."""
    q, k, v = _fa_case(cuda, B, H, Hkv, S, D, dtype, S + D)
    kw = dict(causal=causal, window=window)
    with torch.no_grad():
        o = attention(q, k, v, **kw)
    kernels.reset_launches()
    o2, lse = attention_with_lse(q, k, v, **kw)
    assert kernels.LAUNCHES["flash_attention"] == 1
    assert torch.equal(o, o2)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    _, want = attention_lse_ref(q, k, v, **kw)
    torch.testing.assert_close(lse, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_autograd_on_the_card(cuda, dtype):
    """``attention`` under autograd on the model's (B, S, H, D) transposed
    views: the forward kernel once (the same bits as under no_grad), the
    backward kernel once, no copy, gradients with the views' shapes equal
    to ``attention_bwd_ref``; at D = 64 and, on ``"wide"``, D = 512."""
    g = torch.Generator().manual_seed(11)
    for S, window, D in ((72, None, 64), (300, 100, 64), (130, 50, 512)):
        x = [torch.randn((2, S, h, D), generator=g).to(cuda, dtype)
             .requires_grad_() for h in (8, 2, 2)]
        q, k, v = (t.transpose(1, 2) for t in x)
        with torch.no_grad():
            plain = attention(q, k, v, window=window)
        kernels.reset_launches()
        o = attention(q, k, v, window=window)
        assert kernels.LAUNCHES["flash_attention"] == 1
        assert torch.equal(o, plain)
        do = torch.randn(o.shape, generator=g).to(cuda, dtype)
        assert not any(plan_attention_bwd(q, k, v, o, do).copy)
        o.backward(do)
        assert kernels.LAUNCHES["flash_attention_bwd"] == len(
            plan_attention_bwd(q, k, v, o, do).launches)
        want = attention_bwd_ref(q, k, v, o, do, window=window)
        for t, w in zip(x, want):
            assert t.grad.shape == t.shape
            _fa_bwd_close(t.grad.transpose(1, 2), w, dtype)


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_layer_on_gpu_is_deterministic_and_folds_in_order(cuda, dtype):
    """One MoE layer (moonshot's smoke config at top_k = 6, a router
    skewed so that tokens drop) run twice on the card gives the same bits
    (no atomics), and its combine of the card's own contributions equals
    the plain one-add-a-contribution fold on the CPU bit for bit."""
    from repro_torch.configs.moonshot_v1_16b_a3b import smoke_config
    from repro_torch.models import moe

    cfg = smoke_config().replace(top_k=6, num_experts=16, param_dtype=dtype,
                                 compute_dtype=dtype)
    g = torch.Generator(device="cuda").manual_seed(3)
    p = moe.moe_init(cfg, g)
    p["router"][:, 0] += 4.0
    x = (torch.randn((4, 96, cfg.d_model), generator=g, device="cuda")
         + 1.0).to(cfg.cdtype)
    a, aux = moe.moe_apply(p, x, cfg)
    b, _ = moe.moe_apply(p, x, cfg)
    assert torch.equal(a.view(torch.int16 if dtype == "bfloat16" else torch.int32),
                       b.view(torch.int16 if dtype == "bfloat16" else torch.int32))
    assert float(aux["moe_dropped_frac"]) > 0
    parts = moe.moe_parts(p, x, cfg)
    got = moe.moe_combine(parts.contrib, parts.dispatch.order, cfg.top_k)
    want = moe.moe_combine_ref(parts.contrib.cpu(), parts.dispatch.src_token.cpu(),
                               got.shape[1])
    assert torch.equal(got.cpu().float(), want.float())
    assert torch.equal(got.reshape(a.shape), a)


@pytest.mark.parametrize("family", ["moe", "griffin", "encdec"])
def test_model_families_on_gpu_match_cpu(cuda, family):
    """The moe, griffin and encdec smoke models (float32) on the card
    against the same weights on the CPU, prefill then three decode steps
    (logits ``atol = rtol = 1e-3``): B6 launches once per attention layer
    per prefill (moe: every layer; griffin: each super-block; encdec: the
    encoder's layers not causal, the decoder's causal) and never in
    decode."""
    import copy

    from repro_torch.configs import (moonshot_v1_16b_a3b, recurrentgemma_9b,
                                     seamless_m4t_medium)
    from repro_torch.models import build_model

    mod = {"moe": moonshot_v1_16b_a3b, "griffin": recurrentgemma_9b,
           "encdec": seamless_m4t_medium}[family]
    cfg = mod.smoke_config()
    gpu = build_model(cfg, seed=2, device="cuda")
    cpu = copy.deepcopy(gpu).to("cpu")
    g = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (2, 40), generator=g, dtype=torch.int32)
    batch = {"tokens": tokens}
    if family == "encdec":
        batch["frames"] = torch.randn((2, 24, cfg.d_model), generator=g)
        launches = 2 * cfg.n_layers
    else:
        launches = gpu.n_super if family == "griffin" else cfg.n_layers
    kernels.reset_launches()
    lg, sg = gpu.prefill({n: t.to(cuda) for n, t in batch.items()}, 44)
    assert kernels.LAUNCHES["flash_attention"] == launches
    if family == "encdec":
        assert kernels.VARIANT_LAUNCHES["flash_attention"]["f32"] == launches
    lc, sc = cpu.prefill(batch, 44)
    for step in range(4):
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-3, rtol=1e-3)
        if step == 3:
            break
        tok = torch.randint(0, cfg.vocab, (2, 1), generator=g, dtype=torch.int32)
        lg, sg = gpu.decode_step(sg, tok.to(cuda))
        lc, sc = cpu.decode_step(sc, tok)
        assert kernels.LAUNCHES["flash_attention"] == launches
