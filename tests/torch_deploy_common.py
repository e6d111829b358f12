"""Shared helpers of ``tests/test_torch_deploy.py`` and
``tests/test_torch_backfill.py``: one scenario driven through both
packages (the JAX reference and the port on ``device="cpu"``), and the
comparisons the two files hold the port to.

A :class:`Kit` names one package's classes and views, so a test builds the
same plane, stream and evolution in both.  Tolerances of the port's
answers against JAX's (as in ``tests/test_torch_scenario.py``): bit for
bit for counts, extremes, joins, comparisons and every answer in naive
mode; SUM / MEAN (and ratios over them) in preagg mode ``rtol=1e-5`` (the
bucket states fold in a framework-chosen order at query time);
DISTINCT_APPROX ``rtol=1e-6`` (``log1p``); STD ``verify_view``'s
tolerance plus XLA's FMA residue.  States and reports compare exactly.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.expr as jex
import repro.scenarios as jsc
import repro_torch.scenarios as tsc
from repro.core.consistency import replay_rounds
from repro.data.synthetic import MULTITABLE_DB as JAX_DB
from repro.offline import BackfillSource as JaxBackfill
from repro.serve.service import FeatureService as JaxService
from repro_torch.convert import online_state_to_numpy
from repro_torch.core import expr as tex
from repro_torch.core.scenario import ScenarioPlane
from repro_torch.core.view import FeatureView
from repro_torch.data.synthetic import MULTITABLE_DB, multitable_stream
from repro_torch.offline import BackfillSource
from repro_torch.serve.service import FeatureService


@dataclasses.dataclass
class Kit:
    """One package's entry points: ``x`` holds the expression API
    (``Col``, ``w_sum``, ``range_window``, ...)."""

    name: str
    Plane: type
    Service: type
    View: type
    Backfill: type
    db: object
    x: object
    views: object
    kw: dict

    def plane(self, views, **kw):
        return self.Plane(views, **self.kw, **kw)

    def build_multi(self, name, views, **kw):
        return self.Service.build_multi(name, views, **self.kw, **kw)

    def view(self, name, features):
        return self.View(name, features=features, database=self.db)


def _api(mod):
    return SimpleNamespace(**{n: getattr(mod, n) for n in mod.__all__})


JAX = Kit("jax", jcore.ScenarioPlane, JaxService, jcore.FeatureView,
          JaxBackfill, JAX_DB, _api(jex), jsc.multi_scenario_views, {})
TORCH = Kit("torch", ScenarioPlane, FeatureService, FeatureView,
            BackfillSource, MULTITABLE_DB, _api(tex),
            tsc.multi_scenario_views, {"device": "cpu"})
KITS = (JAX, TORCH)


def tables(seed, n, num_accounts, num_merchants, t_max):
    """The day as numpy (both packages make the same bytes from a seed)."""
    return multitable_stream(np.random.default_rng(seed), n,
                             num_accounts=num_accounts,
                             num_merchants=num_merchants, t_max=t_max)


def bykey(d, kc):
    o = np.lexsort((d["ts"], d[kc]))
    return {c: np.asarray(v)[o] for c, v in d.items()}


def warm(plane, tabs, rounds=False):
    """The secondary tables (key-sorted), then the transactions in one
    batch or in ``replay_rounds`` (one row per key a batch)."""
    for t in plane.store._sec_names:
        plane.ingest_table(t, bykey(tabs[t], MULTITABLE_DB.table(t).key))
    tx = tabs["transactions"]
    if rounds:
        for idx in replay_rounds(tx["account"], tx["ts"]):
            plane.ingest(bykey({c: v[idx] for c, v in tx.items()},
                               "account"))
    else:
        plane.ingest(bykey(tx, "account"))


def state(plane):
    """Every state array of a plane's store as numpy, named as
    ``convert.online_state_to_numpy`` names them (a replicated ring as its
    S replicas)."""
    s = plane.store.state
    if isinstance(s.ring.ts, torch.Tensor):
        return {k: np.ascontiguousarray(v)
                for k, v in online_state_to_numpy(s).items()}
    out = {"ring_ts": s.ring.ts, "ring_vals": s.ring.vals,
           "cursor": s.ring.cursor, "bstats": s.bagg.stats,
           "bbitmap": s.bagg.bitmap, "bbucket": s.bagg.bucket}
    for f in FAMILY_FIELDS:
        if getattr(s.bagg, f) is not None:
            out[f"b{f}"] = getattr(s.bagg, f)
    for i, r in enumerate(s.sec):
        for f in ("ts", "vals", "cursor"):
            out[f"sec{i}_{f}"] = getattr(r, f)
    return {k: np.asarray(v) for k, v in out.items()}


FAMILY_FIELDS = ("seq", "xts", "xpos", "xval", "xhas",
                 "tts", "tpos", "tval", "tvalid")


@pytest.fixture
def jax_families(monkeypatch):
    """Run the JAX package's merge-order bucket families in this
    container.  ``repro.core.preagg._TS_EMPTY`` is a JAX array passed as
    ``fill_value=`` to ``.at[].get(mode="fill")``; jax 0.9.0 requires
    hashable primitive parameters and raises ``TypeError ... fill_value
    was not hashable`` for an array.  The same value as a Python int is
    hashable and gives the same bits.  Scoped to each test by
    ``monkeypatch``: nothing of the JAX package changes on disk, and its
    own tests see the module as it is."""
    import repro.core.preagg as jax_preagg

    monkeypatch.setattr(jax_preagg, "_TS_EMPTY", -2147483648)


def _bits(a):
    a = np.ascontiguousarray(a)
    if a.dtype == np.bool_:
        a = a.astype(np.float32)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_states_equal(a, b, where=""):
    """Two planes' states (or ``state`` dicts), every array bit for bit."""
    a = a if isinstance(a, dict) else state(a)
    b = b if isinstance(b, dict) else state(b)
    assert sorted(a) == sorted(b), where
    for k in a:
        assert a[k].shape == b[k].shape, (where, k, a[k].shape, b[k].shape)
        np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]),
                                      err_msg=f"{where} {k}")


REPORT_FIELDS = ("diff_summary", "exact", "hard_inexact", "carried",
                 "migrated", "fresh", "dropped", "synthesized_lanes",
                 "new_programs", "notes", "backfilled")


def report_fields(r):
    out = {f: getattr(r, f) for f in REPORT_FIELDS}
    out["deficits"] = [(d.target, d.table, d.ring, d.lanes, d.reason)
                       for d in r.deficits]
    return out


def assert_reports_equal(want, got):
    """A port report equals the JAX report field by field."""
    w, g = report_fields(want), report_fields(got)
    for f in w:
        assert g[f] == w[f], (f, g[f], w[f])


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def kinds_of(view):
    """Feature -> tolerance kind against JAX, from its aggregates."""
    from repro_torch.core.expr import collect_window_aggs

    out = {}
    for f, e in view.features.items():
        aggs = {wa.agg.value for wa in collect_window_aggs([e]).values()}
        out[f] = ("std" if "std" in aggs else
                  "distinct" if "distinct_approx" in aggs else
                  "sum" if aggs & {"sum", "mean"} else "exact")
    return out


def assert_close_to_jax(want, got, mode, kinds, amax, where=""):
    assert sorted(want) == sorted(got), where
    for f in want:
        a, g = _np(want[f]), _np(got[f])
        assert a.shape == g.shape, (where, f)
        k = kinds[f]
        if k == "exact" or (k == "sum" and mode == "naive"):
            np.testing.assert_array_equal(_bits(a), _bits(g),
                                          err_msg=f"{where} {f}")
        elif k == "sum":
            np.testing.assert_allclose(g, a, rtol=1e-5, err_msg=f"{where} {f}")
        elif k == "distinct":
            np.testing.assert_allclose(g, a, rtol=1e-6, err_msg=f"{where} {f}")
        else:
            scale = float(np.percentile(np.abs(a), 99)) if a.size else 1.0
            atol = 1e-3 * max(1.0, scale) + 2.0 ** -12 * amax
            assert np.all(np.abs(g - a) <= atol + 2e-4 * np.abs(a)), (where, f)


def assert_bit_equal(a, b, where=""):
    assert sorted(a) == sorted(b), where
    for f in a:
        np.testing.assert_array_equal(_bits(_np(a[f])), _bits(_np(b[f])),
                                      err_msg=f"{where} {f}")


def check_answers(jax_plane, hot, cold, views, req, amax,
                  modes=("naive", "preagg")):
    """Each port view's answers: the hot plane == the cold plane bit for
    bit, and == the JAX hot plane's within the tolerances; ``views`` are
    the port's, the JAX plane answers by the same names."""
    for v in views:
        kinds = kinds_of(v)
        for mode in modes:
            got = hot.query(v.name, dict(req), mode=mode)
            if cold is not None:
                assert_bit_equal(cold.query(v.name, dict(req), mode=mode),
                                 got, f"hot vs cold {v.name} {mode}")
            if jax_plane is not None:
                want = jax_plane.query(v.name, dict(req), mode=mode)
                assert_close_to_jax(want, got, mode, kinds, amax,
                                    f"vs JAX {v.name} {mode}")
