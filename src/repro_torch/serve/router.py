"""Sharded serving front-end — routing + micro-batching over shards.

The serving plane's request dataflow:

    submit(row) ──> BatchScheduler          (coalesce: max_batch / max_wait_us)
        │
        ▼ next_batch()  — padded shape bucket + __valid__ mask
    FeatureService.request
        │
        ▼ ShardedOnlineStore.query          (device-routed: Feistel shard id,
        │                                    route-rank kernel, per-shard grid,
        │                                    query, gather back)
        ▼
    per-request feature rows (submission order)

:class:`ShardRouter` owns that loop and the serving-side observability:
per-shard request occupancy (skew monitoring), fed by the store's own
routing counts (``route_info``) — the router never re-hashes keys.  A
single-device store degrades to S=1.  This is the single-scenario slice of
the reference package's ``repro.serve.router``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs import get_telemetry
from repro_torch.serve.service import BatchScheduler, FeatureService

__all__ = ["ShardRouter"]


class ShardRouter:
    """Micro-batching front-end for a (sharded) single-scenario service.

    ``pump()`` moves one batch through the pipeline; ``drain()`` pumps
    until the queue is empty.  Responses come back as per-request feature
    rows in submission order.
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
        # per-shard request counts — the serving-skew histogram
        self.shard_requests = np.zeros(self.num_shards, np.int64)

    def submit(self, row: Dict, now_us: Optional[int] = None) -> None:
        """Queue one request row."""
        self.scheduler.submit(row, now_us=now_us)

    def _note_route(self, counts: np.ndarray) -> None:
        """Fold one batch's routed-row counts (computed by the store while
        routing, padding excluded) into the skew histogram."""
        hist = np.zeros(self.num_shards, np.int64)
        counts = np.asarray(counts, np.int64)
        hist[: len(counts)] += counts
        self.shard_requests += hist
        get_telemetry().metrics.counter(
            "shard_dispatch_rows_total",
            "request rows dispatched per (scenario, shard)", "1",
            labels=("scenario", "shard"),
            max_series=1024,
        ).inc_along(
            "shard", [str(i) for i in range(self.num_shards)], hist,
            scenario="",
        )

    def pump(
        self, now_us: Optional[int] = None, flush: bool = False
    ) -> Optional[Dict[str, np.ndarray]]:
        """Serve one coalesced batch; None if nothing is ready yet."""
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
        ri: Dict = {}
        out = self.service.request(batch, ingest=self.ingest, route_info=ri)
        self._note_route(ri["shard_counts"])
        return {k: np.asarray(v)[valid] for k, v in out.items()}

    def drain(
        self, now_us: Optional[int] = None
    ) -> Optional[Dict[str, np.ndarray]]:
        """Flush everything queued; concatenated rows in submission order."""
        outs: List[Dict] = []
        while True:
            got = self.pump(now_us=now_us, flush=True)
            if got is None:
                break
            outs.append(got)
        if not outs:
            return None
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}

    def shard_histogram(self) -> np.ndarray:
        """Requests served per shard (copy); real requests only."""
        return self.shard_requests.copy()
