"""Offline↔online consistency verification — FeatInsight §2(3).

The reference package's ``repro.core.consistency``: compute every feature
of a test table twice and compare.

1. offline: :class:`~repro_torch.core.engine.OfflineEngine` batch-computes
   every feature for every row;
2. online: rows are replayed in timestamp order — each row is FIRST
   queried as a request (its window sees the key's earlier rows plus
   itself, the offline point-in-time semantics), THEN ingested;
3. features are compared with a floating-point tolerance (both engines
   are f32; the offline one uses prefix-sum differences, the online one
   masked sums, so bounded relative error is the contract, not bit
   equality).

The replay is batched in rounds in which no key appears twice: within a
round every query is answered against state that excludes the whole
round, which matches offline semantics because windows are per key.

Multi-table views pass their secondary tables through ``secondary``; the
replay then interleaves secondary ingest by timestamp before each round,
as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.engine import OfflineEngine
from repro_torch.core.online import OnlineFeatureStore
from repro_torch.core.view import FeatureView

__all__ = ["ConsistencyReport", "verify_view", "replay_rounds"]


@dataclasses.dataclass
class ConsistencyReport:
    view: str
    version: int
    n_rows: int
    n_features: int
    max_abs_err: float
    max_rel_err: float
    per_feature: Dict[str, float]
    passed: bool
    mode: str

    def summary(self) -> str:
        flag = "PASS" if self.passed else "FAIL"
        return (
            f"[{flag}] view={self.view} v{self.version} rows={self.n_rows} "
            f"features={self.n_features} max_abs={self.max_abs_err:.3e} "
            f"max_rel={self.max_rel_err:.3e} (mode={self.mode})"
        )


def replay_rounds(key: np.ndarray, ts: np.ndarray) -> List[np.ndarray]:
    """Split row indices (ts-sorted) into rounds with unique keys per round:
    round r holds every key's r-th row in timestamp order."""
    key = np.asarray(key)
    if key.size == 0:
        return []
    order = np.argsort(ts, kind="stable")
    k = key[order]
    # occurrence number of each row within its key, in ts order
    by_key = np.argsort(k, kind="stable")
    ks = k[by_key]
    first = np.ones(len(ks), bool)
    first[1:] = ks[1:] != ks[:-1]
    starts = np.maximum.accumulate(np.where(first, np.arange(len(ks)), 0))
    occ = np.empty(len(ks), np.int64)
    occ[by_key] = np.arange(len(ks)) - starts
    rank = np.argsort(occ, kind="stable")  # by round, ts order within
    counts = np.bincount(occ)
    return [r.astype(np.int64)
            for r in np.split(order[rank], np.cumsum(counts)[:-1])]


def verify_view(
    view: FeatureView,
    columns: Dict[str, np.ndarray],
    *,
    num_keys: int,
    capacity: int = 256,
    num_buckets: int = 64,
    bucket_size: int = 64,
    mode: str = "preagg",
    rtol: float = 2e-4,
    atol_scale: float = 1e-3,
    engine: Optional[OfflineEngine] = None,
    secondary: Optional[Dict[str, Dict[str, np.ndarray]]] = None,
    secondary_num_keys: Optional[Dict[str, int]] = None,
    num_shards: Optional[int] = None,
    device_routing: bool = True,
    device="cuda",
) -> ConsistencyReport:
    """Run the full offline-vs-online verification for one view on
    ``device``.  ``num_shards`` replays against a
    :class:`~repro_torch.core.shard.ShardedOnlineStore` of that many shards
    (its answers equal the single store's, so one tolerance serves both);
    ``device_routing=False`` replays it through the host-routed oracle
    (ignored for a single-device replay).

    Multi-table views pass their secondary tables via ``secondary``
    ({table: {col: (M,) array}}).  Before each primary round, every
    secondary row with ``ts <= max(round ts)`` not yet ingested goes into
    its table's rings, so LAST JOIN lookups and union windows see exactly
    the secondary state a live service would hold at that point of the
    stream (early arrivals are invisible: every online path masks
    ``ts <= request ts``).  Capacity contract: a round's early-ingested
    secondary rows must not wrap a key's ring, so size ``capacity`` to the
    per-key secondary row count, as with the primary.
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
        device_routing=device_routing,
        device=device,
    )
    engine = engine or OfflineEngine(device=device)
    offline = {
        k: v.cpu().numpy()
        for k, v in engine.compute(view, columns, secondary).items()
    }

    schema = view.schema
    key = np.asarray(columns[schema.key])
    ts = np.asarray(columns[schema.ts])
    n = len(key)
    host = {c: np.asarray(v) for c, v in columns.items()}

    # per-table event cursors over the rows stably sorted by ts
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
        batch = {c: v[idx] for c, v in host.items()}
        res = store.query(batch, mode=mode)
        for f, v in res.items():
            online[f][idx] = v.cpu().numpy()
        # ingest the round (sorted by key then ts as the store requires)
        sort = np.lexsort((ts[idx], key[idx]))
        store.ingest({c: v[sort] for c, v in batch.items()})

    max_abs = 0.0
    max_rel = 0.0
    per_feature: Dict[str, float] = {}
    ok = True
    for f in view.features:
        a, b = offline[f].astype(np.float64), online[f].astype(np.float64)
        abs_err = np.abs(a - b)
        rel_err = abs_err / np.maximum(np.abs(a), 1.0)
        per_feature[f] = float(abs_err.max(initial=0.0))
        max_abs = max(max_abs, per_feature[f])
        max_rel = max(max_rel, float(rel_err.max(initial=0.0)))
        # scale-aware tolerance: both engines are f32; the offline path
        # uses prefix-sum differences (error ~ eps * running magnitude) and
        # STD the E[x^2] formula (error ~ eps * value^2)
        scale = float(np.percentile(np.abs(a), 99)) if a.size else 1.0
        atol_f = atol_scale * max(1.0, scale)
        if not np.allclose(a, b, rtol=rtol, atol=atol_f):
            ok = False
    return ConsistencyReport(
        view=view.name,
        version=view.version,
        n_rows=n,
        n_features=len(view.features),
        max_abs_err=max_abs,
        max_rel_err=max_rel,
        per_feature=per_feature,
        passed=ok,
        mode=(
            mode
            if num_shards is None
            else f"{mode}/shards={num_shards}"
            + ("" if device_routing else "/host")
        ),
    )
