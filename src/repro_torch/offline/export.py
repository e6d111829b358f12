"""Point-in-time training-set export from serving feature definitions.

FeatInsight's training path: features for model training are computed
*offline* over historical tables, but from the **same feature view** that
answers online requests — that is what makes the exported training set
consistent with what the model will see in production (the paper's
offline/online consistency pillar, §2(3)).

:func:`export_training_set` is that path for this repo: given a
:class:`~repro_torch.core.view.FeatureView` and its full table history, it runs
the offline engine's fused batch program (:meth:`OfflineEngine.compute` —
point-in-time correct per row: each row's windows see rows at ``ts <=``
its own, LAST JOINs gather the latest secondary row at-or-before it) and
gathers the **label rows** — the rows whose (key, ts) are the training
events.  Label rows are actual history rows, which is exactly the online
replay protocol's request semantics (`verify_view`: query a row against
state including itself, then move on), so the export is verifiable
row-for-row against a live store.

:func:`verify_export` runs that verification: replay the history through
an online store (same rounds/interleaving as
:func:`repro_torch.core.consistency.verify_view`, sharded or not), collect
the online answers at the label rows, and compare against the exported
batch under the same f32 tolerance contract
(:mod:`repro_torch.offline.check` runs it as a command).

The port of the reference package's ``repro.offline.export``: the offline
engine and the replayed store live on ``device`` (default ``"cuda"``; the
engine's MIN / MAX / distinct folds launch the fold-levels kernel there),
and the exported columns come back to the host as numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.consistency import replay_rounds
from repro_torch.core.engine import OfflineEngine
from repro_torch.core.online import OnlineFeatureStore
from repro_torch.core.view import FeatureView
from repro_torch.obs import get_telemetry

__all__ = [
    "TrainingSet",
    "ExportCheck",
    "sample_label_rows",
    "export_training_set",
    "verify_export",
]


@dataclasses.dataclass
class TrainingSet:
    """One exported, point-in-time-correct training batch.

    ``rows`` indexes the label rows in the source history (input row
    order); ``features`` holds one (L,) f32 column per view feature,
    evaluated as-of each label row's timestamp.
    """

    view: str
    version: int
    rows: np.ndarray                   # (L,) int64 history row indices
    key: np.ndarray                    # (L,) label-row keys
    ts: np.ndarray                     # (L,) label-row timestamps
    features: Dict[str, np.ndarray]    # {feature: (L,) f32}
    label: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return int(self.rows.shape[0])

    def to_columns(self) -> Dict[str, np.ndarray]:
        """Flat columnar batch (features + key/ts + optional label)."""
        out = {"__key__": self.key, "__ts__": self.ts}
        out.update(self.features)
        if self.label is not None:
            out["__label__"] = self.label
        return out

    def describe(self) -> str:
        return (
            f"training set: view={self.view} v{self.version} "
            f"rows={len(self)} features={len(self.features)}"
            f"{' +label' if self.label is not None else ''}"
        )


def sample_label_rows(
    ts: np.ndarray, n: int, seed: int = 0
) -> np.ndarray:
    """Deterministic label-row sampling: ``n`` distinct row indices drawn
    uniformly over the history (seeded, without replacement), returned in
    row order.  Uniform-over-rows means the sample straddles every
    retention horizon the online plane might have — which is the point:
    training labels do not stop where ring capacity does."""
    ts = np.asarray(ts)
    total = int(ts.shape[0])
    n = min(int(n), total)
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(total, size=n, replace=False).astype(np.int64))


def export_training_set(
    view: FeatureView,
    columns: Dict[str, np.ndarray],
    *,
    label_rows: Optional[np.ndarray] = None,
    n: Optional[int] = None,
    seed: int = 0,
    label: Optional[str] = None,
    secondary: Optional[Dict[str, Dict[str, np.ndarray]]] = None,
    engine: Optional[OfflineEngine] = None,
    registry=None,
    device="cuda",
) -> TrainingSet:
    """Export a point-in-time-correct training set for ``view``.

    ``columns`` is the full primary-table history ({col: (N,) array}),
    ``secondary`` the full secondary-table histories for multi-table
    views.  Label rows come from ``label_rows`` (history row indices) or
    are sampled with :func:`sample_label_rows` (``n`` rows, ``seed``).
    ``label`` names a primary column to carry along as the target.

    When a :class:`~repro_torch.core.view.FeatureRegistry` is passed, the
    export is recorded as a deployment of service ``export:<view>`` —
    training-set lineage next to the serving deployments.  The features
    are computed by ``engine`` (default: an :class:`~repro_torch.core.
    engine.OfflineEngine` on ``device``).
    """
    tel = get_telemetry()
    engine = engine or OfflineEngine(device=device)
    schema = view.schema
    ts_all = np.asarray(columns[schema.ts])
    key_all = np.asarray(columns[schema.key])
    if label_rows is None:
        if n is None:
            raise ValueError("export_training_set needs label_rows= or n=")
        label_rows = sample_label_rows(ts_all, n, seed=seed)
    label_rows = np.asarray(label_rows, np.int64)

    with tel.tracer.span(
        "export", view=view.name, rows=int(label_rows.shape[0]),
        history_rows=int(ts_all.shape[0]),
    ):
        feats = engine.compute(view, columns, secondary or {})
        idx = None
        features = {}
        for f, v in feats.items():
            if idx is None:
                idx = torch.as_tensor(label_rows, device=v.device)
            features[f] = v[idx].cpu().numpy().astype(np.float32)

    out = TrainingSet(
        view=view.name,
        version=view.version,
        rows=label_rows,
        key=key_all[label_rows],
        ts=ts_all[label_rows],
        features=features,
        label=(
            np.asarray(columns[label])[label_rows]
            if label is not None else None
        ),
    )

    m = tel.metrics
    m.counter(
        "export_rows_total", "training-set rows exported", "1",
        labels=("view",),
    ).inc(len(out), view=view.name)
    # label staleness vs the newest history the export saw — the offline
    # mirror of ingest freshness (how far behind "now" each sample is)
    newest = int(ts_all.max()) if ts_all.size else 0
    fresh = m.histogram(
        "export_freshness_seconds",
        "newest-history-ts minus label-ts per exported row", "s",
        labels=("view",),
    )
    ages, counts = np.unique(
        (newest - out.ts).astype(np.int64), return_counts=True
    )
    for age, cnt in zip(ages, counts):
        fresh.observe(float(age), n=int(cnt), view=view.name)

    if registry is not None:
        try:
            registry.get(view.name, view.version)
        except KeyError:
            registry.register(view)
        registry.deploy(
            f"export:{view.name}", view.name, view.version,
            description=(
                f"training-set export ({len(out)} rows, "
                f"{len(out.features)} features, seed={seed})"
            ),
        )
    return out


@dataclasses.dataclass
class ExportCheck:
    """Export-vs-online-replay verification result (one view)."""

    view: str
    history_rows: int
    label_rows: int
    n_features: int
    max_abs_err: float
    per_feature: Dict[str, float]
    passed: bool
    mode: str

    def summary(self) -> str:
        flag = "PASS" if self.passed else "FAIL"
        return (
            f"[{flag}] export view={self.view} labels={self.label_rows}/"
            f"{self.history_rows} features={self.n_features} "
            f"max_abs={self.max_abs_err:.3e} (mode={self.mode})"
        )


def verify_export(
    view: FeatureView,
    columns: Dict[str, np.ndarray],
    training: TrainingSet,
    *,
    num_keys: int,
    capacity: int = 256,
    num_buckets: int = 64,
    bucket_size: int = 64,
    mode: str = "preagg",
    rtol: float = 2e-4,
    atol_scale: float = 1e-3,
    secondary: Optional[Dict[str, Dict[str, np.ndarray]]] = None,
    secondary_num_keys: Optional[Dict[str, int]] = None,
    num_shards: Optional[int] = None,
    device="cuda",
) -> ExportCheck:
    """Row-for-row check: the exported batch equals a live online replay.

    Replays the full history through an online store on ``device`` with
    :func:`~repro_torch.core.consistency.verify_view`'s exact protocol
    (ts-ordered rounds of unique keys; secondary rows interleaved by
    timestamp; query-then-ingest so each request's window includes
    itself), collects the online answers at ``training.rows``, and
    compares under the same scale-aware f32 tolerance.  The online store
    here retains only ``capacity`` rows per key — label rows older than
    the retention horizon still must agree, because both sides'
    *point-in-time* answers for a row depend only on rows at ``ts <=``
    its own, which the replay had ingested by then.
    """
    secondary = secondary or {}
    store = OnlineFeatureStore.create(
        view,
        num_keys=num_keys,
        num_shards=num_shards,
        capacity=capacity,
        num_buckets=num_buckets,
        bucket_size=bucket_size,
        secondary_num_keys=secondary_num_keys,
        device=device,
    )
    schema = view.schema
    key = np.asarray(columns[schema.key])
    ts = np.asarray(columns[schema.ts])
    n = len(key)
    want = set(np.asarray(training.rows, np.int64).tolist())

    sec_events: Dict[str, Dict] = {}
    for t in store._sec_names:
        tsch = view.database.table(t)
        tcols = {c: np.asarray(v) for c, v in secondary[t].items()}
        order = np.argsort(tcols[tsch.ts], kind="stable")
        sec_events[t] = {
            "cols": {c: v[order] for c, v in tcols.items()},
            "ts": tcols[tsch.ts][order],
            "keycol": tsch.key,
            "tscol": tsch.ts,
            "pos": 0,
        }

    def ingest_secondary_upto(tmax: int) -> None:
        for t, ev in sec_events.items():
            hi = int(np.searchsorted(ev["ts"], tmax, side="right"))
            if hi <= ev["pos"]:
                continue
            sl = slice(ev["pos"], hi)
            ev["pos"] = hi
            batch = {c: v[sl] for c, v in ev["cols"].items()}
            sort = np.lexsort((batch[ev["tscol"]], batch[ev["keycol"]]))
            store.ingest_table(t, {c: v[sort] for c, v in batch.items()})

    online = {f: np.zeros(n, np.float32) for f in view.features}
    for idx in replay_rounds(key, ts):
        ingest_secondary_upto(int(ts[idx].max()))
        batch = {c: np.asarray(columns[c])[idx] for c in columns}
        if any(int(i) in want for i in idx):
            res = store.query(batch, mode=mode)
            for f, v in res.items():
                online[f][idx] = v.cpu().numpy()
        sort = np.lexsort((ts[idx], key[idx]))
        store.ingest({c: batch[c][sort] for c in batch})

    rows = np.asarray(training.rows, np.int64)
    max_abs = 0.0
    per_feature: Dict[str, float] = {}
    ok = True
    for f in view.features:
        a = training.features[f].astype(np.float64)
        b = online[f][rows].astype(np.float64)
        abs_err = np.abs(a - b)
        per_feature[f] = float(abs_err.max(initial=0.0))
        max_abs = max(max_abs, per_feature[f])
        scale = float(np.percentile(np.abs(a), 99)) if a.size else 1.0
        atol_f = atol_scale * max(1.0, scale)
        if not np.allclose(a, b, rtol=rtol, atol=atol_f):
            ok = False
    return ExportCheck(
        view=view.name,
        history_rows=n,
        label_rows=int(rows.shape[0]),
        n_features=len(view.features),
        max_abs_err=max_abs,
        per_feature=per_feature,
        passed=ok,
        mode=mode if num_shards is None else f"{mode}/shards={num_shards}",
    )
