"""The port's hot deploy against the JAX package and against itself.

``diff_layouts``, ``migrate_state``, ``OnlineFeatureStore.adopt_layout``,
``ScenarioPlane.evolve`` and ``MultiScenarioService.hot_deploy``: each
test drives the same stream and the same evolution through both packages
(``tests/torch_deploy_common.py``; the port on ``device="cpu"``) and holds
the port

* to JAX: the migrated state bit for bit, the ``MigrationReport`` field
  by field, the answers in both modes at the stated tolerances;
* to itself: hot deploy == a cold rebuild + full replay, bit for bit
  (state and answers), wherever the reference asserts it.

The cases are the reference's ``tests/test_layout.py`` hot-deploy and
evolve tests, plus the port's own: a ``QueryProgram`` compiled before a
deploy, and a ring that has wrapped before a new lane is synthesized.
"""

import numpy as np
import pytest
import torch

from repro.core import diff_layouts as jax_diff_layouts
from repro.core import plan_layout as jax_plan_layout
from repro_torch.core.layout import diff_layouts, plan_layout
from repro_torch.serve.router import ShardRouter
from repro_torch.serve.service import FeatureService
from torch_deploy_common import (
    JAX,
    TORCH,
    assert_bit_equal,
    assert_reports_equal,
    assert_states_equal,
    check_answers,
    state,
    tables,
    warm,
)

K = 16
NM = 8
STORE_KW = dict(
    num_keys=K, capacity=128, num_buckets=512, bucket_size=64,
    secondary_num_keys={"merchants": NM},
)


def _tabs(seed, n=150, t_max=40_000):
    return tables(seed, n, K, NM, t_max)


def _amax(tabs):
    return float(np.abs(tabs["transactions"]["amount"]).max())


def _req(rng_seed=0, amount=None):
    rng = np.random.default_rng(rng_seed)
    return dict(
        account=np.arange(K, dtype=np.int32),
        ts=np.full(K, 50_000, np.int32),
        amount=(rng.gamma(2.0, 10.0, K).astype(np.float32)
                if amount is None else np.full(K, amount, np.float32)),
        merchant=rng.integers(0, NM, K).astype(np.int32),
    )


def _two_views(kit, specs):
    """Views ``va`` / ``vb`` built in ``kit``'s package from ``specs(x)``
    (``x``: the package's expression API)."""
    return [kit.view(name, feats) for name, feats in specs(kit.x)]


# ---------------------------------------------------------------------------
# acceptance: hot deploy on a warm sharded plane == cold rebuild + replay
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_shards", [1, 4, 8])
def test_hot_deploy_bit_exact_vs_rebuild(num_shards):
    tabs = _tabs(400 + num_shards)
    reports, planes = {}, {}
    for kit in (JAX, TORCH):
        views = kit.views()
        svc = kit.build_multi("plane", views[:2], sharded=True,
                              num_shards=num_shards, **STORE_KW)
        hot = svc.plane
        warm(hot, tabs)
        before = hot.ingest_row_counts()
        if kit is TORCH:
            ptrs = [t.data_ptr() for t in (
                hot.store.state.ring.ts, hot.store.state.bagg.stats,
                *(r.vals for r in hot.store.state.sec))]
        report = svc.hot_deploy(views[2])
        assert report.exact, report.notes
        assert report.new_programs == [views[2].name]
        # no re-ingest: carried tables' row accounting is unchanged
        assert hot.ingest_row_counts() == before
        reports[kit.name], planes[kit.name] = report, (svc, hot)
    assert_reports_equal(reports["jax"], reports["torch"])
    svc, hot = planes["torch"]
    # every ring and the bucket store carried: the same buffers
    assert [t.data_ptr() for t in (
        hot.store.state.ring.ts, hot.store.state.bagg.stats,
        *(r.vals for r in hot.store.state.sec))] == ptrs
    views = TORCH.views()
    cold = TORCH.plane(views, num_shards=num_shards, **STORE_KW)
    warm(cold, tabs)
    assert_states_equal(hot, cold, "hot vs cold")
    assert_states_equal(planes["jax"][1], hot, "vs JAX")
    req = _req(num_shards)
    check_answers(planes["jax"][1], hot, cold, views, req, _amax(tabs))
    # the new scenario serves through the service request path too
    out = svc.request({c: v[:8] for c, v in req.items()}, ingest=False,
                      scenario=views[2].name)
    assert set(out) == set(views[2].features)


def _derived(x):
    amt = x.Col("amount")
    w1h = x.range_window(3600, bucket=64)
    return [
        ("va", {"out": x.w_sum(amt, w1h, union=("wires",)),
                "cnt": x.w_count(amt, w1h)}),
        ("vb", {"dbl": x.w_sum(amt * 2.0, w1h),
                "mx": x.w_max(amt * 2.0, w1h),
                "big": x.w_mean(amt > 20.0, w1h)}),
    ]


@pytest.mark.parametrize("num_shards", [None, 4])
def test_evolve_synthesizes_derived_lanes_and_recapacity(num_shards):
    """New derived window-arg lanes and a capacity grow: ring values AND
    bucket states of the new lanes synthesized from the raw-column lanes,
    rings re-laid — bit for bit the rebuild inside the horizon, and the
    JAX migration's state and report."""
    tabs = _tabs(7 if num_shards is None else 7 + num_shards, n=140)
    out = {}
    for kit in (JAX, TORCH):
        va, vb = _two_views(kit, _derived)
        hot = kit.plane([va], num_shards=num_shards, **STORE_KW)
        warm(hot, tabs, rounds=True)
        report = hot.evolve([va, vb], capacity=192)
        assert report.exact, report.notes
        assert any("dbl" in s or "mul" in s
                   for s in report.synthesized_lanes)
        out[kit.name] = (hot, report)
    assert_reports_equal(out["jax"][1], out["torch"][1])
    hot = out["torch"][0]
    va, vb = _two_views(TORCH, _derived)
    kw = {k: v for k, v in STORE_KW.items() if k != "capacity"}
    cold = TORCH.plane([va, vb], num_shards=num_shards, capacity=192, **kw)
    warm(cold, tabs, rounds=True)
    assert_states_equal(hot, cold, "hot vs cold")
    assert_states_equal(out["jax"][0], hot, "vs JAX")
    check_answers(out["jax"][0], hot, cold, [va, vb], _req(amount=25.0),
                  _amax(tabs))


def _split(x):
    amt = x.Col("amount")
    w1h = x.range_window(3600, bucket=64)
    return [
        ("va", {"out": x.w_sum(amt, w1h, union=("wires",))}),
        ("vb", {"wire_amt": x.last_join(x.Col("amount"), "wires",
                                        on="account")}),
    ]


def test_evolve_splits_dual_use_table():
    """A union table gaining a LAST JOIN splits live: the union part stays
    partitioned (stored once), a narrow replicated join slice is rebuilt
    from the partitioned rows key by key — bit for bit the rebuild and
    the JAX migration."""
    S = 4
    tabs = _tabs(11, n=120)
    n_wires = len(tabs["wires"]["ts"])
    out = {}
    for kit in (JAX, TORCH):
        va, vb = _two_views(kit, _split)
        hot = kit.plane([va], num_shards=S, **STORE_KW)
        warm(hot, tabs)
        counts0 = hot.store.ring_row_counts()
        assert counts0[("wires", "partitioned")].sum() == n_wires
        report = hot.evolve([va, vb])
        assert report.exact, report.notes
        out[kit.name] = (hot, report)
    assert_reports_equal(out["jax"][1], out["torch"][1])
    hot = out["torch"][0]
    counts = hot.store.ring_row_counts()
    assert counts[("wires", "partitioned")].sum() == n_wires
    assert counts[("wires", "partitioned")].max() < n_wires
    assert (counts[("wires", "replicated")] == n_wires).all()
    join_ix = hot.layout.join_ring("wires")
    assert len(hot.layout.tables[join_ix].lanes) == 1
    # the join slice is one copy on the card, seen as S replicas
    assert hot.store.state.sec[join_ix].vals.stride(0) == 0
    va, vb = _two_views(TORCH, _split)
    cold = TORCH.plane([va, vb], num_shards=S, **STORE_KW)
    warm(cold, tabs)
    assert_states_equal(hot, cold, "hot vs cold")
    assert_states_equal(out["jax"][0], hot, "vs JAX")
    check_answers(out["jax"][0], hot, cold, [va, vb], _req(amount=1.0),
                  _amax(tabs))


def _drop(x):
    amt = x.Col("amount")
    w1h = x.range_window(3600, bucket=64)
    return [
        ("va", {"big": x.w_mean(amt > 10.0, w1h), "cnt": x.w_count(amt, w1h)}),
        ("vb", {"dbl": x.w_sum(amt * 2.0, w1h)}),
    ]


def test_evolve_can_drop_a_scenario():
    """Dropping a view removes its lanes (a lane PERMUTE for the
    survivors) and its program; the shrunken plane equals a fresh build +
    replay and the JAX migration."""
    tabs = _tabs(23, n=100)
    out = {}
    for kit in (JAX, TORCH):
        va, vb = _two_views(kit, _drop)
        # vb first, so its derived lane precedes va's in the plan
        hot = kit.plane([vb, va], num_shards=4, **STORE_KW)
        warm(hot, tabs, rounds=True)
        report = hot.evolve([va])
        assert report.exact, report.notes
        assert hot.scenarios == ["va"]
        with pytest.raises(KeyError, match="unknown scenario"):
            hot.query("vb", {})
        out[kit.name] = (hot, report)
    assert_reports_equal(out["jax"][1], out["torch"][1])
    hot = out["torch"][0]
    va, _ = _two_views(TORCH, _drop)
    cold = TORCH.plane([va], num_shards=4, **STORE_KW)
    warm(cold, tabs, rounds=True)
    assert_states_equal(hot, cold, "hot vs cold")
    assert_states_equal(out["jax"][0], hot, "vs JAX")
    check_answers(out["jax"][0], hot, cold, [va], _req(amount=15.0),
                  _amax(tabs))


def test_unsupported_diffs_fail_loudly():
    """Shard count, bucket width, routing mode and key domain changes are
    refused with the reference's messages, naming a rebuild."""
    msgs = []
    for kit, plan, diff in ((JAX, jax_plan_layout, jax_diff_layouts),
                            (TORCH, plan_layout, diff_layouts)):
        views = kit.views()
        a = plan(views, num_shards=4, raw_lanes=True, **STORE_KW)
        kw = {k: v for k, v in STORE_KW.items()
              if k not in ("bucket_size", "num_buckets")}
        others = [
            plan(views, num_shards=8, raw_lanes=True, **STORE_KW),
            plan(views, num_shards=4, raw_lanes=True, bucket_size=32,
                 num_buckets=1024, **kw),
            plan(views, num_shards=4, raw_lanes=True, hash_routing=False,
                 **STORE_KW),
            plan(views, num_shards=4, raw_lanes=True,
                 **dict(STORE_KW, num_keys=2 * K)),
        ]
        got = []
        for b, match in zip(others, ("shard count", "bucket_size",
                                     "routing modes", "rebuild")):
            with pytest.raises(ValueError, match=match) as ei:
                diff(a, b)
            got.append(str(ei.value))
        plane = kit.plane(views[:1], num_shards=4, **STORE_KW)
        with pytest.raises(ValueError, match="rebuild") as ei:
            plane.evolve(views[:1], bucket_size=32)
        got.append(str(ei.value))
        msgs.append(got)
    assert msgs[0] == msgs[1]


def _hashed(x):
    amt = x.Col("amount")
    w1h = x.range_window(3600, bucket=64)
    return [
        ("va", {"cnt": x.w_count(amt, w1h)}),
        ("vb", {"hashed": x.w_count(x.Hash(x.Col("merchant"), bits=8),
                                    w1h)}),
    ]


def test_unsynthesizable_lane_needs_rebuild():
    """A new lane with hash nodes cannot be synthesized bit-exactly from
    stored f32 columns: the evolution refuses with the reference's
    message, and the refusal is atomic — every state tensor's bytes and
    buffers unchanged, the same answers, ingest still works."""
    tabs = _tabs(2, n=60)
    msgs = []
    for kit in (JAX, TORCH):
        va, vb = _two_views(kit, _hashed)
        plane = kit.plane([va], **STORE_KW)
        warm(plane, tabs)
        with pytest.raises(ValueError, match="rebuild") as ei:
            plane.evolve([va, vb])
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    va, vb = _two_views(TORCH, _hashed)
    plane = TORCH.plane([va], **STORE_KW)
    warm(plane, tabs)
    req = _req(amount=1.0)
    before = plane.query("va", req)
    before_state = state(plane)
    s = plane.store.state
    ptrs = [t.data_ptr() for t in (s.ring.ts, s.ring.vals, s.ring.cursor,
                                   s.bagg.stats, s.bagg.bitmap,
                                   s.bagg.bucket)]
    layout = plane.store.layout
    with pytest.raises(ValueError, match="rebuild"):
        plane.evolve([va, vb])
    assert plane.scenarios == ["va"] and plane.store.layout is layout
    assert_states_equal(before_state, plane, "after a refused evolve")
    s = plane.store.state
    assert [t.data_ptr() for t in (s.ring.ts, s.ring.vals, s.ring.cursor,
                                   s.bagg.stats, s.bagg.bitmap,
                                   s.bagg.bucket)] == ptrs
    assert_bit_equal(before, plane.query("va", req))
    plane.ingest(dict(
        account=np.array([1], np.int32), ts=np.array([60_000], np.int32),
        amount=np.array([5.0], np.float32), merchant=np.array([0], np.int32),
    ))


def _horizon(x):
    amt = x.Col("amount")
    w = x.range_window(512, bucket=64)
    return [("va", {"cnt": x.w_count(amt, w)}),
            ("vb", {"dbl": x.w_sum(amt * 2.0, w)})]


def test_horizon_exceeded_flags_inexact():
    """Shrinking capacity while adding a derived lane loses aged-out rows
    for the bucket-state rebuild: exact=False with the reference's notes,
    and the same (inexact) state as the JAX migration."""
    kw = dict(num_keys=4, capacity=32, num_buckets=64, bucket_size=64,
              secondary_num_keys={"merchants": NM})
    rng = np.random.default_rng(31)
    n = 200  # 50 rows/key: cursor (50) > min(32, 16) -> rows aged out
    rows = dict(
        account=np.repeat(np.arange(4, dtype=np.int32), n // 4),
        ts=np.tile(np.arange(n // 4, dtype=np.int32) * 10, 4),
        amount=rng.gamma(2.0, 10.0, n).astype(np.float32),
        merchant=np.zeros(n, np.int32),
    )
    out = {}
    for kit in (JAX, TORCH):
        va, vb = _two_views(kit, _horizon)
        plane = kit.plane([va], **kw)
        plane.ingest(dict(rows))
        report = plane.evolve([va, vb], capacity=16)
        assert not report.exact
        assert any("aged out" in note for note in report.notes)
        out[kit.name] = (plane, report)
    assert_reports_equal(out["jax"][1], out["torch"][1])
    assert_states_equal(out["jax"][0], out["torch"][0], "vs JAX")


def _wrapped(x):
    amt = x.Col("amount")
    w1h = x.range_window(3600, bucket=64)
    return [("va", {"s": x.w_sum(amt, w1h)}),
            ("vb", {"s3": x.w_sum(amt * 3.0, w1h)})]


def test_wrapped_ring_new_lane_inexact_in_both():
    """A ring of 4 rows that one key has filled 7 times over (one batch a
    row, all in one bucket): the new lane's bucket state folds the 4
    retained rows in slot order, and the 3 aged-out rows are lost — the
    reference reports exact=False, and so does the port, with the same
    state bit for bit (the slot-order fold included)."""
    kw = dict(num_keys=4, capacity=4, num_buckets=64, bucket_size=64,
              secondary_num_keys={"merchants": NM})
    amounts = np.array([3.5, 1.25, 7.0, 2.75, 9.5, 0.5, 4.0], np.float32)
    out = {}
    for kit in (JAX, TORCH):
        va, vb = _two_views(kit, _wrapped)
        plane = kit.plane([va], **kw)
        for i, a in enumerate(amounts):
            plane.ingest(dict(
                account=np.array([1], np.int32),
                ts=np.array([3_600 + i], np.int32),
                amount=np.array([a], np.float32),
                merchant=np.array([0], np.int32)))
        report = plane.evolve([va, vb])
        assert not report.exact
        assert any("aged out" in n for n in report.notes)
        out[kit.name] = (plane, report)
    assert_reports_equal(out["jax"][1], out["torch"][1])
    assert_states_equal(out["jax"][0], out["torch"][0], "vs JAX")
    plane = out["torch"][0]
    lane = plane.store.layout.primary.lane_keys.index(
        TORCH.x.Col("amount").__mul__(3.0).key)
    slot = (3_600 // 64) % 64
    # the rows in the ring are 4..6 and 3 (slot order), times 3
    got = plane.store.state.bagg.stats[1, slot, lane, 0]
    want = np.float32(0.0)
    for a in amounts[[4, 5, 6, 3]] * np.float32(3.0):
        want = np.float32(want + a)
    assert got.item() == float(want)


# ---------------------------------------------------------------------------
# the port's own: programs across a deploy; the router after a hot deploy
# ---------------------------------------------------------------------------


def test_query_program_survives_deploy():
    """A QueryProgram compiled before a deploy (whose lanes and rings
    move) answers after it exactly as one compiled afterwards."""
    tabs = _tabs(5, n=120)
    va, vb = _two_views(TORCH, _derived)
    for num_shards in (None, 4):
        plane = TORCH.plane([va], num_shards=num_shards, **STORE_KW)
        warm(plane, tabs, rounds=True)
        old = plane.program("va")
        plane.evolve([vb, va], capacity=192)   # vb's lanes first
        assert plane.program("va") is old
        fresh = plane.store.compile_program(va)
        req = _req(3)
        for mode in ("naive", "preagg"):
            assert_bit_equal(
                plane.store.query(dict(req), mode=mode, program=fresh),
                plane.store.query(dict(req), mode=mode, program=old),
                f"S={num_shards} {mode}")


def test_router_histogram_after_hot_deploy():
    """scenario_shard_histogram() grows a row for a scenario hot-deployed
    AFTER the router was built, and counts its traffic."""
    views = TORCH.views()
    svc = FeatureService.build_multi(
        "p", views[:2], sharded=True, num_shards=4, device="cpu", **STORE_KW
    )
    router = ShardRouter(svc, ingest=False)
    router.submit(dict(account=3, ts=100, amount=1.0, merchant=0),
                  scenario=views[0].name)
    router.drain()
    with pytest.raises(KeyError, match="unknown scenario"):
        router.submit(dict(account=3, ts=101, amount=1.0, merchant=0),
                      scenario=views[2].name)
    svc.hot_deploy(views[2])
    with pytest.raises(ValueError, match="already deployed"):
        svc.hot_deploy(views[2])
    for i in range(4):
        router.submit(dict(account=i, ts=200 + i, amount=1.0, merchant=i % NM),
                      scenario=views[2].name)
    router.drain()
    hists = router.scenario_shard_histogram()
    assert views[2].name in hists
    assert int(hists[views[2].name].sum()) == 4
    assert int(sum(h.sum() for h in hists.values())) == 5
    np.testing.assert_array_equal(sum(hists.values()),
                                  router.shard_histogram())


def test_hot_deploy_keeps_state_on_its_device():
    """The new entry points run where their store runs; nothing here moves
    state to another device."""
    views = TORCH.views()
    svc = TORCH.build_multi("p", views[:2], **STORE_KW)
    report = svc.hot_deploy(views[2])
    assert report.exact
    s = svc.plane.store.state
    assert all(t.device == torch.device("cpu")
               for t in (s.ring.ts, s.bagg.stats, *(r.ts for r in s.sec)))
