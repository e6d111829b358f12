"""Sharded serving front-end — routing + micro-batching over shards.

The serving plane's request dataflow:

    submit(row) ──> BatchScheduler          (coalesce: max_batch / max_wait_us)
        │
        ▼ next_batch()  — padded shape bucket + __valid__ mask
    FeatureService.request / MultiScenarioService.request_mixed
        │
        ▼ ShardedOnlineStore.query / route_and_query
        │     device-routed (default): Feistel shard id, route-rank
        │     kernel, per-shard grid, query, gather back — one dispatch
        │     host-routed (``device_routing=False``, the oracle): rows
        │     bucketed by shard on the host, one query, scatter back on
        │     the host
        ▼
    per-request feature rows (submission order)

:class:`ShardRouter` owns that loop and the serving-side observability:
per-shard request occupancy (skew monitoring), fed by the store's own
routing counts (``route_info``) — the router never re-hashes keys.  A
single-device store degrades to S=1.

**Multi-scenario routing** (``FeatureService.build_multi``): requests are
submitted with a scenario tag and coalesce in ONE queue.  With device
routing the whole mixed batch goes through
:meth:`~repro_torch.serve.service.MultiScenarioService.request_mixed` —
ONE dispatch answers every (scenario, shard) bucket, and each scenario's
rows come back in submission order.  With the host oracle each popped
batch is split by scenario on the host and every group runs its own
program.  Occupancy is tracked per (scenario, shard) in
:meth:`ShardRouter.scenario_shard_histogram` under both.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs import get_telemetry
from repro_torch.serve.service import (
    SCENARIO_COL,
    BatchScheduler,
    FeatureService,
    MultiScenarioService,
)

__all__ = ["ShardRouter"]


class ShardRouter:
    """Micro-batching front-end for a (sharded, multi-scenario) service.

    ``pump()`` moves one batch through the pipeline; ``drain()`` pumps
    until the queue is empty (flushing any open coalescing window).
    Responses come back as per-request feature rows in submission order —
    for a multi-scenario service, per scenario:
    ``{scenario: {feature: rows-in-submission-order}}``.
    """

    def __init__(
        self,
        service: FeatureService,
        scheduler: Optional[BatchScheduler] = None,
        ingest: bool = True,
    ):
        self.service = service
        self.scheduler = scheduler if scheduler is not None else BatchScheduler()
        self.ingest = ingest
        self.num_shards = int(getattr(service.store, "num_shards", 1))
        self.scenarios: Optional[List[str]] = (
            list(service.scenarios)
            if isinstance(service, MultiScenarioService)
            else None
        )
        # per-shard request counts — the serving-skew histogram (summed
        # over scenarios), plus the per-(scenario, shard) breakdown of a
        # multi-scenario deployment
        self.shard_requests = np.zeros(self.num_shards, np.int64)
        self.scenario_shard_requests: Dict[str, np.ndarray] = {
            s: np.zeros(self.num_shards, np.int64)
            for s in (self.scenarios or ())
        }

    def _sync_scenarios(self) -> None:
        """Follow the service's live scenario list (a plane may gain
        scenarios after this router was built): new scenarios get their
        per-(scenario, shard) histograms."""
        if self.scenarios is None:
            return
        live = list(self.service.scenarios)
        if live != self.scenarios:
            self.scenarios = live
            for s in live:
                self.scenario_shard_requests.setdefault(
                    s, np.zeros(self.num_shards, np.int64)
                )

    def submit(
        self,
        row: Dict,
        now_us: Optional[int] = None,
        scenario: Optional[str] = None,
    ) -> None:
        """Queue one request row; a multi-scenario service requires the
        ``scenario`` tag (which view answers this row)."""
        self._sync_scenarios()
        if self.scenarios is not None:
            if scenario is None:
                raise ValueError(
                    "multi-scenario router: submit(..., scenario=) required "
                    f"(one of {self.scenarios})"
                )
            if scenario not in self.scenario_shard_requests:
                raise KeyError(
                    f"unknown scenario {scenario!r}; service has "
                    f"{self.scenarios}"
                )
            row = dict(row)
            row[SCENARIO_COL] = scenario
        elif scenario is not None:
            raise ValueError(
                f"service {self.service.name!r} is single-scenario; "
                "submit() takes no scenario tag"
            )
        self.scheduler.submit(row, now_us=now_us)

    def _note_route(self, counts: np.ndarray,
                    scenario: Optional[str]) -> None:
        """Fold one batch's routed-row counts (computed by the store while
        routing, padding excluded) into the skew histograms and the
        per-(scenario, shard) dispatch counter."""
        hist = np.zeros(self.num_shards, np.int64)
        counts = np.asarray(counts, np.int64)
        hist[: len(counts)] += counts
        self.shard_requests += hist
        if scenario is not None:
            self.scenario_shard_requests[scenario] += hist
        get_telemetry().metrics.counter(
            "shard_dispatch_rows_total",
            "request rows dispatched per (scenario, shard)", "1",
            labels=("scenario", "shard"),
            max_series=1024,
        ).inc_along(
            "shard", [str(i) for i in range(self.num_shards)], hist,
            scenario=scenario or "",
        )

    def pump(
        self, now_us: Optional[int] = None, flush: bool = False
    ) -> Optional[Dict[str, np.ndarray]]:
        """Serve one coalesced batch; None if nothing is ready yet."""
        self._sync_scenarios()
        batch = self.scheduler.next_batch(now_us=now_us, flush=flush)
        if batch is None:
            return None
        valid = np.asarray(batch["__valid__"], bool)
        get_telemetry().metrics.gauge(
            "batch_occupancy_ratio",
            "real rows / padded batch rows, last batch", "1",
            labels=("service",),
        ).set(
            float(valid.sum()) / max(len(valid), 1),
            service=self.service.name,
        )
        if self.scenarios is None:
            ri: Dict = {}
            out = self.service.request(batch, ingest=self.ingest,
                                       route_info=ri)
            self._note_route(ri["shard_counts"], None)
            return {k: np.asarray(v)[valid] for k, v in out.items()}
        if getattr(self.service.store, "device_routing", False):
            # device routing: the mixed batch is ONE dispatch — the store
            # routes, answers and counts every (scenario, shard) bucket
            ri = {}
            results = self.service.request_mixed(
                batch, ingest=self.ingest, route_info=ri
            )
            scounts = np.asarray(ri["scenario_shard_counts"])
            for i, s in enumerate(ri["scenario_names"]):
                self._note_route(scounts[i], s)
            return results
        # host oracle: split the popped batch by scenario tag (submission
        # order within each group) and run each group through its own
        # program.  Ingest waits until EVERY group is answered, so the
        # whole batch is answered as of the batch's start — as the single
        # dispatch answers it; a later group must not see an earlier
        # group's rows of the same batch.
        tags = np.asarray(batch[SCENARIO_COL])
        results = {}
        groups = []
        for s in self.scenarios:
            m = valid & (tags == s)
            if not m.any():
                continue
            rows_s = {
                c: np.asarray(v)[m]
                for c, v in batch.items()
                if c not in ("__valid__", SCENARIO_COL)
            }
            ri = {}
            results[s] = self.service.request(
                rows_s, ingest=False, scenario=s, route_info=ri
            )
            # rows_s was masked by `m`, so every row is a real request
            self._note_route(ri["shard_counts"], s)
            groups.append(rows_s)
        if self.ingest:
            schema = self.service.view.schema
            for rows_s in groups:
                data = {
                    c: np.asarray(v)
                    for c, v in rows_s.items()
                    if not c.startswith("__")
                }
                order = np.lexsort((data[schema.ts], data[schema.key]))
                self.service.store.ingest(
                    {c: v[order] for c, v in data.items()}
                )
        return results

    def drain(
        self, now_us: Optional[int] = None
    ) -> Optional[Dict[str, np.ndarray]]:
        """Flush everything queued; concatenated rows in submission order
        (per scenario, for a multi-scenario service)."""
        outs: List[Dict] = []
        while True:
            got = self.pump(now_us=now_us, flush=True)
            if got is None:
                break
            outs.append(got)
        if not outs:
            return None
        if self.scenarios is None:
            return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
        # pumps arrive in submission order: collect each scenario's chunks,
        # then concatenate each (scenario, feature) once
        merged: Dict[str, Dict[str, List[np.ndarray]]] = {}
        for o in outs:
            for s, cols in o.items():
                dst = merged.setdefault(s, {})
                for k, v in cols.items():
                    dst.setdefault(k, []).append(v)
        return {
            s: {k: np.concatenate(vs) for k, vs in cols.items()}
            for s, cols in merged.items()
        }

    def shard_histogram(self) -> np.ndarray:
        """Requests served per shard, summed over scenarios (copy); real
        requests only."""
        return self.shard_requests.copy()

    def scenario_shard_histogram(self) -> Dict[str, np.ndarray]:
        """Per-(scenario, shard) request occupancy (copies); real requests
        only, as in :meth:`shard_histogram`."""
        return {
            s: h.copy() for s, h in self.scenario_shard_requests.items()
        }
