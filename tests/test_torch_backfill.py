"""The port's offline bridge against the JAX package and against itself.

Two contracts, as in the reference's ``tests/test_backfill.py``:

* **Export**: ``export_training_set`` over the multi-table view (LAST
  JOINs + a WINDOW UNION stream) equals an online replay row for row at
  label times *beyond* the online rings' retention horizon, across shard
  counts; its columns equal JAX's export within ``tests/
  test_torch_offline.py``'s offline-engine tolerances (the centering
  mean's rounding; exact where the reference is exact).
* **Backfill**: migrations that would refuse or report ``exact=False``
  because history aged out (a capacity grow after wrap; a new hash lane
  underivable from stored f32 columns) complete bit for bit with a
  ``BackfillSource``: the port's state equals JAX's and a cold rebuild +
  full replay, its report equals JAX's field by field.  Uncoverable
  backfills refuse with the reference's messages.

The merge-order families (FIRST / TOPN_FREQ over RANGE windows)
backfill too: deployed onto a plane whose rings aged out history, they are
re-derived from the full stream, and the port's state equals JAX's (run
with the ``jax_families`` fixture, see ``tests/torch_deploy_common.py``)
and a cold rebuild + replay bit for bit.
"""

import numpy as np
import pytest

from repro.core.layout import plan_layout as jax_plan_layout
from repro.offline import export_training_set as jax_export
from repro.scenarios import multi_table_view as jax_multi_table_view
from repro_torch.core.layout import plan_layout
from repro_torch.core.view import FeatureRegistry
from repro_torch.offline import (
    BackfillSource,
    export_training_set,
    sample_label_rows,
    verify_export,
)
from repro_torch.scenarios import multi_table_view
from torch_deploy_common import (
    JAX,
    TORCH,
    assert_bit_equal,
    assert_reports_equal,
    assert_states_equal,
    check_answers,
    jax_families,  # noqa: F401  (a fixture)
    state,
    tables,
    warm,
)

K = 16            # accounts: few keys so rings wrap fast
NM = 8            # merchants
ROWS = 600
T_MAX = 60_000    # t_max/bucket_size=937 < num_buckets: no bucket wrap
SMALL_CAP = 16    # << rows/key (~37): primary rings age out most rows
GROWN_CAP = 64
SEC_NK = {"merchants": NM}
KW = dict(
    num_keys=K, capacity=SMALL_CAP, num_buckets=1024, bucket_size=64,
    secondary_num_keys=SEC_NK,
)


@pytest.fixture(scope="module")
def tabs():
    return tables(17, ROWS, K, NM, T_MAX)


def _amax(tabs):
    return float(max(tabs["transactions"]["amount"].max(),
                     tabs["wires"]["amount"].max()))


def _sig(x):
    """A view whose window argument is a Signature lane — never
    synthesizable from stored f32 columns."""
    w1h = x.range_window(3600, bucket=64)
    sig = x.Signature((x.Col("merchant"),), bits=8)
    return {"sig_cnt_1h": x.w_count(sig, w1h),
            "sig_sum_1h": x.w_sum(sig, w1h)}


def _probe(tabs):
    return {c: v[:16] for c, v in tabs["transactions"].items()}


# ---------------------------------------------------------------------------
# training-set export == online replay, == JAX's export
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def training(tabs):
    secondary = {t: c for t, c in tabs.items() if t != "transactions"}
    return export_training_set(
        multi_table_view(), tabs["transactions"], n=64, seed=3,
        secondary=secondary, device="cpu",
    )


def test_labels_straddle_retention_horizon(tabs, training):
    """The label rows include rows the online rings have aged out by the
    end of the replay, and rows still inside the horizon."""
    tx = tabs["transactions"]
    key, ts = tx["account"], tx["ts"]
    newer = np.array([
        int(((key == key[i]) & (ts > ts[i])).sum()) for i in training.rows
    ])
    assert (newer >= SMALL_CAP).any(), "no label row beyond the horizon"
    assert (newer < SMALL_CAP).any(), "no label row inside the horizon"


def test_export_matches_jax_export(tabs, training):
    """The port's TrainingSet equals JAX's: the same label rows, keys and
    timestamps, the columns within the offline engine's tolerances; and a
    registry records the export as service ``export:<view>``."""
    secondary = {t: c for t, c in tabs.items() if t != "transactions"}
    want = jax_export(jax_multi_table_view(), tabs["transactions"], n=64,
                      seed=3, secondary=secondary)
    for f in ("rows", "key", "ts"):
        np.testing.assert_array_equal(getattr(training, f), getattr(want, f))
    assert training.version == want.version and training.view == want.view
    np.testing.assert_array_equal(
        training.rows, sample_label_rows(tabs["transactions"]["ts"], 64, 3))
    got, ref = training.features, want.features
    assert sorted(got) == sorted(ref)
    amax = _amax(tabs)
    for f in ("credit_limit", "acct_risk", "merchant_reports",
              "outflow_cnt_1h", "big_vs_limit"):
        np.testing.assert_array_equal(got[f].view(np.int32),
                                      np.asarray(ref[f]).view(np.int32), f)
    cnt = float(np.asarray(ref["outflow_cnt_1h"]).max())
    np.testing.assert_allclose(got["outflow_sum_1h"], ref["outflow_sum_1h"],
                               rtol=1e-5, atol=1e-5 * amax * cnt + 1e-6)
    np.testing.assert_allclose(got["outflow_mean_1h"], ref["outflow_mean_1h"],
                               rtol=1e-5, atol=1e-5 * amax)
    credit = float(tabs["accounts"]["credit_limit"].min())
    np.testing.assert_allclose(got["limit_utilization"],
                               ref["limit_utilization"], rtol=1e-5,
                               atol=1e-5 * amax * cnt / credit)
    reg = FeatureRegistry()
    out = export_training_set(
        multi_table_view(), tabs["transactions"], label_rows=training.rows,
        label="amount", secondary=secondary, registry=reg, device="cpu")
    assert_bit_equal(out.features, training.features)
    np.testing.assert_array_equal(
        out.label, tabs["transactions"]["amount"][training.rows])
    assert reg.service("export:fraud_multitable")["view"] == "fraud_multitable"
    with pytest.raises(ValueError, match="label_rows= or n="):
        export_training_set(multi_table_view(), tabs["transactions"],
                            device="cpu")


@pytest.mark.parametrize("shards", [1, 4, 8])
def test_export_matches_online_replay(tabs, training, shards):
    secondary = {t: c for t, c in tabs.items() if t != "transactions"}
    check = verify_export(
        multi_table_view(), tabs["transactions"], training,
        num_keys=K,
        capacity=SMALL_CAP,
        secondary=secondary,
        secondary_num_keys=SEC_NK,
        num_shards=None if shards == 1 else shards,
        device="cpu",
    )
    assert check.passed, check.summary()
    assert check.label_rows == len(training)


# ---------------------------------------------------------------------------
# backfilled migrations: previously inexact / refused -> bit-exact
# ---------------------------------------------------------------------------


def _both(tabs, build_views, target_views, shards=4, backfill=True,
          src_tables=None, **evolve_kw):
    """Warm ``build_views`` on a plane in each package, evolve it to
    ``target_views`` (with a source over ``src_tables`` when
    ``backfill``); returns {package: (plane, report)}."""
    out = {}
    for kit in (JAX, TORCH):
        plane = kit.plane(build_views(kit), num_shards=shards, **KW)
        warm(plane, tabs)
        src = (kit.Backfill(kit.db, tabs if src_tables is None
                            else src_tables) if backfill else None)
        report = plane.evolve(target_views(kit), backfill=src, **evolve_kw)
        out[kit.name] = (plane, report)
    assert_reports_equal(out["jax"][1], out["torch"][1])
    assert_states_equal(out["jax"][0], out["torch"][0], "vs JAX")
    return out


def test_capacity_grow_inexact_without_backfill(tabs):
    out = _both(tabs, lambda k: k.views()[:2], lambda k: k.views()[:3],
                backfill=False, capacity=GROWN_CAP)
    report = out["torch"][1]
    assert not report.exact
    assert report.deficits, "expected an aged-out-history deficit"


@pytest.mark.parametrize("shards", [None, 4])
def test_capacity_grow_backfill_bit_exact(tabs, shards):
    out = _both(tabs, lambda k: k.views()[:2], lambda k: k.views()[:3],
                shards=shards, capacity=GROWN_CAP)
    plane, report = out["torch"]
    assert report.exact, report.notes
    assert report.backfilled, "expected spliced deficits in the report"
    views = TORCH.views()
    cold = TORCH.plane(views[:3], num_shards=shards,
                       **dict(KW, capacity=GROWN_CAP))
    warm(cold, tabs)
    assert_states_equal(plane, cold, "backfilled vs rebuild + replay")
    probe = _probe(tabs)
    assert_bit_equal(plane.query(views[2].name, dict(probe)),
                     cold.query(views[2].name, dict(probe)))


def test_refused_hash_lane_backfill_bit_exact(tabs):
    def target(k):
        return k.views()[:2] + [k.view("merchant_mix", _sig(k.x))]

    # without a source: refused outright, with the reference's message
    msgs = []
    for kit in (JAX, TORCH):
        plane = kit.plane(kit.views()[:2], num_shards=4, **KW)
        warm(plane, tabs)
        with pytest.raises(ValueError, match="rebuild") as ei:
            plane.evolve(target(kit), capacity=GROWN_CAP)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] and "backfill" in msgs[1]

    out = _both(tabs, lambda k: k.views()[:2], target, capacity=GROWN_CAP)
    plane, report = out["torch"]
    assert report.exact, report.notes
    assert report.backfilled
    cold = TORCH.plane(target(TORCH), num_shards=4,
                       **dict(KW, capacity=GROWN_CAP))
    warm(cold, tabs)
    assert_states_equal(plane, cold, "backfilled vs rebuild + replay")
    check_answers(out["jax"][0], plane, cold, target(TORCH)[2:],
                  _probe(tabs), _amax(tabs))


def _order_view(x):
    """The reference's ``order_view``: a view whose bucket state is the
    merge-order families, deployed onto a warm plane whose rings have
    already aged out history."""
    w1h = x.range_window(3600, bucket=64)
    return {"amt_first_1h": x.w_first(x.Col("amount"), w1h),
            "amt_top_1h": x.w_topn_freq(x.Col("amount"), w1h, n=0)}


def test_merge_order_family_backfill_matches_jax(tabs, jax_families):
    """FIRST / TOPN_FREQ over RANGE windows deployed with a
    ``BackfillSource``: the report and every state array (the families
    included) equal JAX's, the state equals a cold rebuild + replay, and
    the answers equal the cold plane's and JAX's bit for bit."""
    def target(k):
        return k.views()[:2] + [k.view("order_mix", _order_view(k.x))]

    out = _both(tabs, lambda k: k.views()[:2], target, capacity=GROWN_CAP)
    plane, report = out["torch"]
    assert report.exact, report.notes
    assert report.backfilled
    assert state(plane)["btvalid"].any() and state(plane)["bxhas"].any()
    cold = TORCH.plane(target(TORCH), num_shards=4,
                       **dict(KW, capacity=GROWN_CAP))
    warm(cold, tabs)
    assert_states_equal(plane, cold, "backfilled vs rebuild + replay")
    check_answers(out["jax"][0], plane, cold, target(TORCH)[2:],
                  _probe(tabs), _amax(tabs))


@pytest.mark.parametrize("shards", [None, 4])
def test_merge_order_family_backfill_bit_exact(tabs, shards):
    """The reference's test of the same name, on the port: without a
    source the families are rebuilt from ring-retained rows only (a bucket
    deficit, not silence); with one, full-history re-derivation equals a
    cold rebuild + replay bit for bit, answers included."""
    views = TORCH.views()
    target = views[:2] + [TORCH.view("order_mix", _order_view(TORCH.x))]
    plane = TORCH.plane(views[:2], num_shards=shards, **KW)
    warm(plane, tabs)
    report = plane.evolve(target, capacity=GROWN_CAP)
    assert not report.exact
    assert any(d.target == "bucket" for d in report.deficits), (
        report.deficits)

    plane2 = TORCH.plane(views[:2], num_shards=shards, **KW)
    warm(plane2, tabs)
    src = BackfillSource(TORCH.db, tabs)
    report2 = plane2.evolve(target, backfill=src, capacity=GROWN_CAP)
    assert report2.exact, report2.notes
    assert report2.backfilled
    cold = TORCH.plane(target, num_shards=shards,
                       **dict(KW, capacity=GROWN_CAP))
    warm(cold, tabs)
    assert_states_equal(plane2, cold, "backfilled vs rebuild + replay")
    probe = _probe(tabs)
    for mode in ("preagg", "naive"):
        assert_bit_equal(plane2.query("order_mix", dict(probe), mode=mode),
                         cold.query("order_mix", dict(probe), mode=mode),
                         mode)


# ---------------------------------------------------------------------------
# unsynthesizable backfills refuse loudly, naming the offender
# ---------------------------------------------------------------------------


def _refusal(tabs, src_tables, match):
    msgs = []
    for kit in (JAX, TORCH):
        plane = kit.plane(kit.views()[:2], num_shards=4, **KW)
        warm(plane, tabs)
        before = state(plane) if kit is TORCH else None
        src = kit.Backfill(kit.db, src_tables)
        with pytest.raises(ValueError, match=match) as ei:
            plane.evolve(kit.views()[:3], backfill=src, capacity=GROWN_CAP)
        msgs.append(str(ei.value))
    # the refused splice is atomic: the plane serves as before
    assert plane.scenarios == [v.name for v in TORCH.views()[:2]]
    assert_states_equal(before, plane, "after a refused splice")
    assert msgs[0] == msgs[1]
    return msgs[1]


def test_splice_refuses_missing_column_naming_view(tabs):
    crippled = {
        t: {c: v for c, v in cols.items() if c != "amount"}
        for t, cols in tabs.items()
    }
    msg = _refusal(tabs, crippled, "cannot backfill")
    assert "amount" in msg
    assert "extend the backfill source" in msg


def test_splice_refuses_missing_table(tabs):
    _refusal(tabs, {t: c for t, c in tabs.items() if t != "transactions"},
             "no history for table")


def test_splice_refuses_history_that_is_not_the_stream(tabs):
    """The cursor tripwire: a history missing one ingested row does not
    reproduce the online stream's per-key counts."""
    short = dict(tabs)
    short["transactions"] = {c: v[1:] for c, v in
                             tabs["transactions"].items()}
    _refusal(tabs, short, "does not reproduce the online stream")


def test_source_validates_tables_and_columns(tabs):
    with pytest.raises(KeyError):
        BackfillSource(TORCH.db, {"nope": tabs["transactions"]})
    with pytest.raises(ValueError, match="required"):
        BackfillSource(
            TORCH.db,
            {"transactions": {
                c: v for c, v in tabs["transactions"].items() if c != "ts"
            }},
        )
    with pytest.raises(ValueError, match="ragged"):
        BackfillSource(
            TORCH.db,
            {"transactions": dict(
                tabs["transactions"], amount=tabs["transactions"]["amount"][:5]
            )},
        )


# ---------------------------------------------------------------------------
# per-table retention knobs
# ---------------------------------------------------------------------------


def test_per_table_capacity_selective_backfill(tabs):
    """A short-retention table triggers backfill where a long one carries:
    only the wires ring (capacity 4, wrapped) is deficient on a grow."""
    base = dict(capacity=128, table_capacity={"wires": 4})
    grow = dict(capacity=128, table_capacity={"wires": 32})
    out = {}
    for kit in (JAX, TORCH):
        plane = kit.plane(kit.views()[:2], num_shards=4, **dict(KW, **base))
        warm(plane, tabs)
        out[kit.name] = (plane, plane.evolve(kit.views()[:2], **grow))
    assert_reports_equal(out["jax"][1], out["torch"][1])
    report = out["torch"][1]
    assert not report.exact
    assert all("wires" in d.describe() for d in report.deficits)

    out = {}
    for kit in (JAX, TORCH):
        plane = kit.plane(kit.views()[:2], num_shards=4, **dict(KW, **base))
        warm(plane, tabs)
        src = kit.Backfill(kit.db, tabs)
        out[kit.name] = (plane, plane.evolve(kit.views()[:2], backfill=src,
                                             **grow))
    assert_reports_equal(out["jax"][1], out["torch"][1])
    plane, report = out["torch"]
    assert report.exact, report.notes
    assert all("wires" in b for b in report.backfilled)
    assert_states_equal(out["jax"][0], plane, "vs JAX")
    cold = TORCH.plane(TORCH.views()[:2], num_shards=4, **dict(KW, **grow))
    warm(cold, tabs)
    assert_states_equal(plane, cold, "backfilled vs rebuild + replay")


def test_backfill_plan_introspection(tabs):
    """``BackfillSource.plan`` resolves each deficit to an action with its
    history rows, per-shard split and coverage, touching no state."""
    from repro_torch.core.layout import diff_layouts
    from repro_torch.core.migrate import migrate_state

    views = TORCH.views()
    plane = TORCH.plane(views[:2], num_shards=4, **KW)
    warm(plane, tabs)
    new = plan_layout(views[:3], raw_lanes=True, num_shards=4,
                      **dict(KW, capacity=GROWN_CAP))
    diff = diff_layouts(plane.store.layout, new)
    _, report = migrate_state(diff, plane.store.state, plane.store)
    src = BackfillSource(TORCH.db, tabs)
    bplan = src.plan(diff, report, plane.store)
    assert bplan.covered and len(bplan.actions) == len(report.deficits)
    n_tx = len(tabs["transactions"]["ts"])
    prim = [a for a in bplan.actions if a.ring is None and a.target == "ring"]
    assert prim and prim[0].rows == n_tx
    assert sum(prim[0].rows_per_shard) == n_tx
    assert "history rows" in bplan.describe()


def test_planner_knobs_land_on_rings_and_validate():
    views = TORCH.views()
    kw = dict(num_keys=K, capacity=32, num_buckets=1024,
              secondary_num_keys=SEC_NK,
              table_capacity={"wires": 8, "transactions": 64},
              table_ttl={"wires": 4000})
    lay = plan_layout(views, **kw)
    want = jax_plan_layout(JAX.views(), **kw)
    assert lay.describe() == want.describe()
    assert [p.identity() for p in (lay.primary,) + lay.tables] == [
        p.identity() for p in (want.primary,) + want.tables]
    assert lay.primary.capacity == 64 and lay.primary.ttl is None
    by_table = {rp.table: rp for rp in lay.tables}
    assert by_table["wires"].capacity == 8
    assert by_table["wires"].ttl == 4000
    assert all(
        rp.capacity == 32 for t, rp in by_table.items() if t != "wires"
    )
    with pytest.raises(ValueError, match="unknown table"):
        plan_layout(views, num_keys=K, num_buckets=1024,
                    secondary_num_keys=SEC_NK, table_capacity={"nope": 8})
    with pytest.raises(ValueError, match="unknown table"):
        plan_layout(views, num_keys=K, num_buckets=1024,
                    secondary_num_keys=SEC_NK, table_ttl={"nope": 60})


def test_check_command_on_the_cpu(capsys):
    """``python -m repro_torch.offline.check --device cpu`` at the
    reference's sizes: export == online replay, single-device and 4
    shards; exit code 0."""
    from repro_torch.offline import check

    assert check.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("[PASS]") == 2 and "row for row: OK" in out
