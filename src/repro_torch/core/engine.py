"""Offline feature computation engine (training-set export path).

The reference package's ``repro.core.engine``: all features of a view are
evaluated in one pass over the (key, ts)-sorted table, with shared window
starts, prefix sums and fold levels computed once
(:func:`repro_torch.core.windows.windowed_aggregate`); rows are evaluated
data-parallel, not one key per worker, so a hot key costs no more than a
cold one; :func:`shard_rows` splits the sorted table at key boundaries.

Multi-table views work here too: each referenced secondary table is
(key, ts)-sorted once, LAST JOINs resolve with one point-in-time binary
search + gather per (table, join expression), and WINDOW UNION
aggregations run the window machinery over the timestamp-merged streams.

``compile`` returns a plain closure per ``(view.name, view.version)``,
cached (``compile_count`` counts the builds).  It is not
``torch.compile``d: that could re-associate the TwoSum prefix arithmetic.
The engine's tensors live on ``device`` (default ``"cuda"``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import as_tensor, resolve_device
from repro_torch.core.expr import (
    collect_last_joins,
    collect_tables,
    collect_window_aggs,
    eval_rowlevel,
)
from repro_torch.core.join import last_join_gather, merge_streams
from repro_torch.core.view import FeatureView
from repro_torch.core.windows import sort_by_key_ts, windowed_aggregate

__all__ = ["OfflineEngine", "shard_rows"]

Tables = Dict[str, Dict[str, object]]


class OfflineEngine:
    """Compiles feature views to batch executables over historical tables
    on ``device``."""

    def __init__(self, device="cuda") -> None:
        self.device = resolve_device(device)
        self._cache: Dict[Tuple[str, int], Callable] = {}
        self.compile_count = 0

    def _sorted_table(self, schema, columns) -> Dict[str, torch.Tensor]:
        """A table's columns on the device, stably (key, ts)-sorted, plus
        the sort permutation under ``None``."""
        dev = self.device
        key = as_tensor(columns[schema.key], dev).to(torch.int32)
        ts = as_tensor(columns[schema.ts], dev).to(torch.int32)
        others = [c for c in columns if c not in (schema.key, schema.ts)]
        srt = sort_by_key_ts(key, ts, *[as_tensor(columns[c], dev)
                                        for c in others])
        cols = {schema.key: srt[0], schema.ts: srt[1]}
        cols.update(zip(others, srt[2:-1]))
        cols[None] = srt[-1]
        return cols

    def compile(self, view: FeatureView) -> Callable:
        """The executable for a view (cached per version)."""
        key = (view.name, view.version)
        if key in self._cache:
            return self._cache[key]

        feature_names = list(view.features)
        exprs = list(view.features.values())
        waggs = collect_window_aggs(exprs)
        ljoins = collect_last_joins(exprs)
        db = view.database
        schema = view.schema
        needed = collect_tables(exprs)

        def run(
            columns: Dict[str, object], secondary: Optional[Tables] = None
        ) -> Dict[str, torch.Tensor]:
            secondary = secondary or {}
            for t in needed:
                if t not in secondary:
                    raise KeyError(
                        f"view {view.name!r} references table {t!r}; pass it "
                        "via secondary={...}"
                    )
            sorted_cols = self._sorted_table(schema, columns)
            perm = sorted_cols.pop(None)
            skey, sts = sorted_cols[schema.key], sorted_cols[schema.ts]

            # one (key, ts) sort per referenced secondary table, shared by
            # every join / union touching it
            sec_sorted: Dict[str, Dict[str, torch.Tensor]] = {}
            for t in needed:
                cols_t = self._sorted_table(db.table(t), secondary[t])
                cols_t.pop(None)
                sec_sorted[t] = cols_t

            pre_vals: Dict[Tuple, torch.Tensor] = {}

            # -- LAST JOINs: point-in-time searchsorted gather --------------
            for lk, lj in ljoins.items():
                tsch = db.table(lj.table)
                cols_t = sec_sorted[lj.table]
                argv = eval_rowlevel(lj.arg, cols_t, {}).to(torch.float32)
                pre_vals[lk] = last_join_gather(
                    cols_t[tsch.key],
                    cols_t[tsch.ts],
                    argv,
                    sorted_cols[lj.on].to(torch.int32),
                    sts,
                    default=lj.default,
                )

            # -- window aggregations, grouped by union signature ------------
            groups: Dict[Tuple[str, ...], Dict] = {}
            for wk, wa in waggs.items():
                groups.setdefault(wa.union, {})[wk] = wa

            arg_cache: Dict[Tuple, torch.Tensor] = {}

            def primary_arg(wa) -> torch.Tensor:
                ak = wa.arg.key
                if ak not in arg_cache:
                    arg_cache[ak] = eval_rowlevel(
                        wa.arg, sorted_cols, {}
                    ).to(torch.float32)
                return arg_cache[ak]

            for union, group in groups.items():
                if not union:
                    requests = {
                        wk: (wa.agg, primary_arg(wa), wa.window, wa.n)
                        for wk, wa in group.items()
                    }
                    pre_vals.update(windowed_aggregate(skey, sts, requests))
                    continue
                # WINDOW UNION: merge the union streams (secondaries first,
                # so ts-tied union rows land inside the primary row's
                # window), aggregate over the merged stream, read back at
                # primary positions.
                u_schemas = [db.table(t) for t in union]
                perm_m, key_m, ts_m, rank_m = merge_streams(
                    [sec_sorted[t][s.key] for t, s in zip(union, u_schemas)]
                    + [skey],
                    [sec_sorted[t][s.ts] for t, s in zip(union, u_schemas)]
                    + [sts],
                )
                # the primary rows' merged positions (one per primary row;
                # nonzero reads the count back to the host)
                prim_pos = torch.nonzero(rank_m == len(union))[:, 0]
                requests = {}
                for wk, wa in group.items():
                    args = [
                        eval_rowlevel(wa.arg, sec_sorted[t], {}).to(
                            torch.float32
                        )
                        for t in union
                    ] + [primary_arg(wa)]
                    arg_m = torch.cat(args).index_select(0, perm_m)
                    requests[wk] = (wa.agg, arg_m, wa.window, wa.n)
                merged_vals = windowed_aggregate(key_m, ts_m, requests)
                for wk, v in merged_vals.items():
                    pre_vals[wk] = v.index_select(0, prim_pos)

            out = {}
            inv = torch.empty_like(perm)
            inv[perm.long()] = torch.arange(
                perm.shape[0], dtype=perm.dtype, device=perm.device
            )
            inv = inv.long()
            for fname in feature_names:
                v = eval_rowlevel(view.features[fname], sorted_cols, pre_vals)
                out[fname] = v[inv]  # back to input row order
            return out

        self._cache[key] = run
        self.compile_count += 1
        return run

    def compute(
        self,
        view: FeatureView,
        columns: Dict[str, object],
        secondary: Optional[Tables] = None,
    ) -> Dict[str, torch.Tensor]:
        """Offline batch feature computation (row order preserved).

        ``columns`` maps column -> (N,) array or tensor; ``secondary`` maps
        secondary table name -> {col: (M,) array} for multi-table views.
        Returns {feature: (N,) tensor on the engine's device}.
        """
        return self.compile(view)(columns, secondary or {})

    def export_training_set(
        self,
        view: FeatureView,
        columns: Dict[str, object],
        label: Optional[str] = None,
        path: Optional[str] = None,
        secondary: Optional[Tables] = None,
    ) -> Dict[str, np.ndarray]:
        """Compute features offline and export samples: returns (and
        optionally ``.npz``-writes) the feature matrix + label as numpy."""
        feats = self.compute(view, columns, secondary)
        out = {k: v.cpu().numpy() for k, v in feats.items()}
        if label is not None:
            out["__label__"] = np.asarray(columns[label])
        if path is not None:
            np.savez_compressed(path, **out)
        return out


def shard_rows(key: np.ndarray, num_shards: int) -> np.ndarray:
    """Assign each (sorted) row to a shard, splitting at key boundaries:
    a balanced contiguous partition of the sorted rows that never splits a
    key across shards."""
    n = len(key)
    target = np.linspace(0, n, num_shards + 1)[1:-1].astype(np.int64)
    cuts = []
    for t in target:
        t = int(t)
        while t < n and t > 0 and key[t] == key[t - 1]:
            t += 1
        cuts.append(t)
    bounds = [0] + cuts + [n]
    shard = np.zeros(n, np.int32)
    for s in range(num_shards):
        shard[bounds[s]:bounds[s + 1]] = s
    return shard
