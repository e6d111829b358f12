"""Online feature service — FeatInsight §3.1 step 4 — and the §3.3
scoring service on top of it.

``FeatureService`` is the paper's deployment unit: a named, versioned view
bound to an online store, answering request rows with feature vectors
under a latency budget.  ``BatchScheduler`` is the serving loop's
micro-batcher: requests coalesce up to ``max_batch`` or ``max_wait_us``
(whichever first) and are padded to a fixed batch shape.
``ScoringService`` turns request rows into fraud scores: features, a
signature embedding of the key, then the model.

A service deploys any view, multi-table ones included (its store takes
``secondary_num_keys`` / ``table_capacity`` / ``table_ttl`` /
``device_routing`` through ``build``; request rows carry the LAST JOIN
key columns).  ``FeatureService.build_multi`` deploys N scenario views as
one :class:`MultiScenarioService` on one shared
:class:`~repro_torch.core.scenario.ScenarioPlane`: requests name their
scenario (``scenario=``), and a mixed batch tagged per row
(:data:`SCENARIO_COL`) is answered in one device-routed dispatch
(:meth:`MultiScenarioService.request_mixed`);
:meth:`MultiScenarioService.hot_deploy` adds a scenario to the live plane
without a rebuild.  Answers come back as numpy arrays on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.online import OnlineFeatureStore
from repro_torch.core.view import FeatureRegistry, FeatureView
from repro_torch.obs import get_telemetry

__all__ = [
    "ServiceStats",
    "FeatureService",
    "MultiScenarioService",
    "BatchScheduler",
    "ScoringService",
    "SCENARIO_COL",
]

# meta column carrying the per-row scenario tag of a mixed batch (set by
# ShardRouter.submit, read by MultiScenarioService.request_mixed)
SCENARIO_COL = "__scenario__"


@dataclasses.dataclass
class ServiceStats:
    """Request counters + latency distributions.

    The paper's latency claims are *tail*-latency claims (<20 ms at
    QPS > 1000), so the stats keep rings of recent samples and report
    percentiles, not just the mean.

    Two distributions live here:

    * **per-request** (``request_p50_ms`` / ``request_p95_ms`` /
      ``request_p99_ms``): one sample per request — queue wait plus the
      wall time of the batch that served it — so a 64-request batch
      contributes 64 samples and the tail reflects what a user request
      actually experienced.  This is the authoritative latency metric.
    * **per-batch** (``p50_ms`` / ``p95_ms`` / ``p99_ms``): one sample per
      batch wall time, *unweighted* by batch size.  Deprecated — kept
      working for existing dashboards/tests, but it under-weights busy
      batches (a 1-row batch counts the same as a 256-row one) and
      excludes queue wait.  New code should read the request percentiles.
    """

    requests: int = 0
    batches: int = 0
    total_latency_s: float = 0.0
    window: int = 1024
    recent_latency_s: List[float] = dataclasses.field(
        default_factory=list, repr=False
    )
    recent_request_latency_s: List[float] = dataclasses.field(
        default_factory=list, repr=False
    )

    def observe(self, latency_s: float, n_requests: int) -> None:
        """Record one served batch (batch wall time + request count).

        Without per-request wait attribution, each of the batch's
        requests is also credited the batch wall time in the per-request
        ring; :meth:`observe_requests` overrides that with true
        wait-inclusive samples when the caller has them.
        """
        self.requests += n_requests
        self.batches += 1
        self.total_latency_s += latency_s
        self.recent_latency_s.append(latency_s)
        if len(self.recent_latency_s) > self.window:
            del self.recent_latency_s[: len(self.recent_latency_s) - self.window]

    def observe_requests(self, latencies_s: Sequence[float]) -> None:
        """Record per-request end-to-end latencies (wait + batch wall)."""
        self.recent_request_latency_s.extend(float(x) for x in latencies_s)
        if len(self.recent_request_latency_s) > self.window:
            del self.recent_request_latency_s[
                : len(self.recent_request_latency_s) - self.window
            ]

    @property
    def mean_latency_ms(self) -> float:
        return 1e3 * self.total_latency_s / max(self.batches, 1)

    def percentile_ms(self, p: float) -> float:
        """DEPRECATED batch-latency percentile (unweighted by batch size)."""
        if not self.recent_latency_s:
            return 0.0
        return 1e3 * float(np.percentile(np.asarray(self.recent_latency_s), p))

    def request_percentile_ms(self, p: float) -> float:
        """Per-request latency percentile (queue wait + batch wall time)."""
        if not self.recent_request_latency_s:
            return 0.0
        return 1e3 * float(
            np.percentile(np.asarray(self.recent_request_latency_s), p)
        )

    @property
    def p50_ms(self) -> float:
        return self.percentile_ms(50.0)

    @property
    def p95_ms(self) -> float:
        return self.percentile_ms(95.0)

    @property
    def p99_ms(self) -> float:
        return self.percentile_ms(99.0)

    @property
    def request_p50_ms(self) -> float:
        return self.request_percentile_ms(50.0)

    @property
    def request_p95_ms(self) -> float:
        return self.request_percentile_ms(95.0)

    @property
    def request_p99_ms(self) -> float:
        return self.request_percentile_ms(99.0)


class FeatureService:
    """A deployed (view, version) answering online feature requests."""

    def __init__(
        self,
        name: str,
        view: FeatureView,
        store: OnlineFeatureStore,
        registry: Optional[FeatureRegistry] = None,
        mode: str = "preagg",
    ):
        self.name = name
        self.view = view
        self.store = store
        self.mode = mode
        self.registry = registry
        self.stats = ServiceStats()
        if registry is not None:
            registry.deploy(name, view.name, view.version)

    @classmethod
    def build(
        cls,
        name: str,
        view: FeatureView,
        *,
        num_keys: int,
        registry: Optional[FeatureRegistry] = None,
        mode: str = "preagg",
        sharded: bool = False,
        num_shards: Optional[int] = None,
        device="cuda",
        **store_kwargs,
    ) -> "FeatureService":
        """Construct the service together with its online store on
        ``device``.

        ``sharded=True`` deploys on a :class:`~repro_torch.core.shard.
        ShardedOnlineStore` with ``num_shards`` key-partitioned shards
        (required: one GPU holds every shard, so there is no device count
        to default from); answers equal the single-device store's.  The
        other ``store_kwargs`` (sizes, ``secondary_num_keys``,
        ``table_capacity``, ``table_ttl``, ``hash_routing``,
        ``device_routing``) go to the store.
        """
        if not sharded and num_shards is not None:
            raise ValueError("num_shards requires sharded=True")
        if sharded and num_shards is None:
            raise ValueError("sharded=True needs an explicit num_shards")
        store = OnlineFeatureStore.create(
            view, num_keys=num_keys, num_shards=num_shards, device=device,
            **store_kwargs,
        )
        return cls(name, view, store, registry=registry, mode=mode)

    @classmethod
    def build_multi(
        cls,
        name: str,
        views: Sequence[FeatureView],
        *,
        num_keys: int,
        registry: Optional[FeatureRegistry] = None,
        mode: str = "preagg",
        sharded: bool = False,
        num_shards: Optional[int] = None,
        device="cuda",
        **store_kwargs,
    ) -> "MultiScenarioService":
        """Deploy N scenario views as ONE service on ONE shared store on
        ``device``.

        The views are fused into a :class:`~repro_torch.core.scenario.
        ScenarioPlane`: shared tables are ingested and stored once (per
        shard placement, with ``sharded=True``, which needs an explicit
        ``num_shards``), and each view queries through its own program,
        bit for bit a dedicated single-view store's answers.  Requests
        carry a ``scenario=`` tag: ``svc.request(rows, scenario="fraud")``;
        per-scenario latency / QPS lands in ``svc.scenario_stats[...]``
        beside the aggregate ``svc.stats``.
        """
        from repro_torch.core.scenario import ScenarioPlane

        if not sharded and num_shards is not None:
            raise ValueError("num_shards requires sharded=True")
        if sharded and num_shards is None:
            raise ValueError("sharded=True needs an explicit num_shards")
        plane = ScenarioPlane(
            views, num_keys=num_keys, num_shards=num_shards, name=name,
            device=device, **store_kwargs,
        )
        return MultiScenarioService(name, plane, registry=registry, mode=mode)

    # -- per-request hooks (MultiScenarioService overrides them) --------------

    def _compute(
        self,
        rows: Dict[str, np.ndarray],
        scenario: Optional[str],
        valid: Optional[np.ndarray] = None,
        route_info: Optional[Dict] = None,
    ) -> Dict[str, torch.Tensor]:
        if scenario is not None:
            raise ValueError(
                f"service {self.name!r} is single-scenario; scenario= tags "
                "need a FeatureService.build_multi deployment"
            )
        return self.store.query(
            rows, mode=self.mode, valid=valid, route_info=route_info
        )

    def _observe(
        self,
        latency_s: float,
        n_requests: int,
        scenario: Optional[str],
        request_latencies_s: Optional[np.ndarray] = None,
    ) -> None:
        self.stats.observe(latency_s, n_requests)
        if request_latencies_s is not None:
            self.stats.observe_requests(request_latencies_s)

    def _scenario_features(self, scenario: Optional[str]) -> Sequence[str]:
        return self.view.features

    def request(self, rows: Dict[str, np.ndarray],
                ingest: bool = True,
                scenario: Optional[str] = None,
                route_info: Optional[Dict] = None) -> Dict[str, np.ndarray]:
        """Compute features for a batch of request rows; optionally ingest
        them afterwards (the online-learning pattern of the paper).

        Batches from :class:`BatchScheduler` carry a ``__valid__`` mask over
        padding rows (the last real row repeated up to the shape bucket)
        and a ``__wait_us__`` per-row queue-wait column.  All ``__``-meta
        columns are stripped before querying; the mask is honored on ingest
        — padding rows are duplicates of a real row, so ingesting them
        would corrupt window state (double-counted sums, inflated counts).
        The wait column attributes per-request latency: each request's
        sample is its queue wait plus this batch's wall time.

        ``scenario`` selects which view answers on a multi-scenario
        deployment (see :meth:`build_multi`); ingested rows land in the
        shared store once, serving every scenario.  ``route_info`` (dict,
        filled in place) surfaces the store's per-shard routing counts to
        the caller — the router's skew histograms read them instead of
        re-hashing keys.
        """
        tel = get_telemetry()
        t0 = tel.clock.now()
        valid = rows.get("__valid__")
        wait_us = rows.get("__wait_us__")
        rows = {c: v for c, v in rows.items() if not c.startswith("__")}
        n_rows = len(next(iter(rows.values())))
        n_real = int(np.asarray(valid, bool).sum()) if valid is not None else n_rows
        with tel.tracer.span(
            "request", service=self.name, scenario=scenario or "",
            rows=n_real,
        ):
            out = self._compute(
                rows, scenario, valid=valid, route_info=route_info
            )
            out = {k: v.cpu().numpy() for k, v in out.items()}
            if ingest:
                real = rows
                if valid is not None:
                    valid = np.asarray(valid, bool)
                    real = {c: np.asarray(v)[valid] for c, v in rows.items()}
                if len(next(iter(real.values()))):
                    key = np.asarray(real[self.view.schema.key])
                    ts = np.asarray(real[self.view.schema.ts])
                    order = np.lexsort((ts, key))
                    self.store.ingest(
                        {c: np.asarray(v)[order] for c, v in real.items()}
                    )
        dt = tel.clock.now() - t0
        # per-request latency = that request's queue wait + batch wall time
        if wait_us is not None:
            waits_s = np.asarray(wait_us, np.float64)[:n_rows] / 1e6
            if valid is not None:
                waits_s = waits_s[np.asarray(valid, bool)]
            else:
                waits_s = waits_s[:n_real]
        else:
            waits_s = np.zeros(n_real, np.float64)
        req_lat = waits_s + dt
        m = tel.metrics
        m.counter(
            "service_requests_total", "requests served", "1",
            labels=("service", "scenario"),
        ).inc(n_real, service=self.name, scenario=scenario or "")
        m.histogram(
            "request_latency_seconds",
            "per-request latency (queue wait + batch wall)", "s",
            labels=("service",),
        ).observe_array(req_lat, service=self.name)
        if wait_us is not None and len(waits_s):
            m.histogram(
                "queue_wait_seconds", "scheduler queue wait per request",
                "s", labels=("service",),
            ).observe_array(waits_s, service=self.name)
        if valid is not None and n_rows:
            m.gauge(
                "batch_occupancy_ratio",
                "real rows / padded batch rows, last batch", "1",
                labels=("service",),
            ).set(n_real / n_rows, service=self.name)
        self._observe(dt, n_real, scenario, req_lat)
        return out

    def feature_matrix(
        self, rows: Dict[str, np.ndarray], scenario: Optional[str] = None
    ) -> np.ndarray:
        """(B, F) float32 features of ``rows`` in the (scenario's) view's
        feature order, without ingesting them."""
        out = self.request(rows, ingest=False, scenario=scenario)
        feats = self._scenario_features(scenario)
        return np.stack([out[f] for f in feats], axis=-1)


class MultiScenarioService(FeatureService):
    """One deployment serving N scenarios from one shared store.

    ``view`` / ``store`` are the plane's merged view and shared store, so
    everything written against :class:`FeatureService` (routers, stats
    consumers, ingest paths) keeps working; queries additionally take the
    ``scenario=`` tag and answer with that view's features by their own
    (un-prefixed) names.  Deploy records land in the registry as
    ``"<service>:<scenario>"`` per scenario.
    """

    def __init__(
        self,
        name: str,
        plane,  # repro_torch.core.scenario.ScenarioPlane
        registry: Optional[FeatureRegistry] = None,
        mode: str = "preagg",
    ):
        self.plane = plane
        super().__init__(name, plane.merged, plane.store, mode=mode)
        self.registry = registry
        self.scenario_stats: Dict[str, ServiceStats] = {
            s: ServiceStats() for s in plane.scenarios
        }
        if registry is not None:
            for s, v in plane.views.items():
                registry.deploy(f"{name}:{s}", v.name, v.version)

    @property
    def scenarios(self) -> List[str]:
        return self.plane.scenarios

    def hot_deploy(self, view: FeatureView, backfill=None, **plan_overrides):
        """Deploy one more scenario onto the LIVE plane — no rebuild, no
        re-ingest, no downtime for the scenarios already serving.

        Drives :meth:`~repro_torch.core.scenario.ScenarioPlane.evolve`: the
        layout planner re-plans for ``views + [view]``, the running store's
        state migrates to the new plan on the device (carried buffers
        verbatim, new lanes synthesized from history), and only the new
        view gets a :class:`~repro_torch.core.online.QueryProgram`.  The
        deployment is recorded in the registry as
        ``"<service>:<scenario>"`` with a ``hot deploy`` description (the
        view is registered first if the registry does not know it), and a
        fresh per-scenario :class:`ServiceStats` starts counting.

        ``backfill`` (a :class:`repro_torch.offline.backfill.
        BackfillSource`) lets the deployment reach beyond the rings'
        retention horizon: aged-out state is re-derived from offline
        history and spliced in, keeping ``report.exact``.

        Returns the :class:`~repro_torch.core.migrate.MigrationReport`.
        """
        if view.name in self.plane.views:
            raise ValueError(
                f"scenario {view.name!r} is already deployed on "
                f"{self.name!r}; hot_deploy adds new scenarios"
            )
        tel = get_telemetry()
        with tel.tracer.span(
            "hot_deploy", service=self.name, scenario=view.name
        ):
            report = self.plane.evolve(
                list(self.plane.views.values()) + [view],
                backfill=backfill, **plan_overrides,
            )
        tel.metrics.counter(
            "hot_deploys_total", "scenarios hot-deployed onto live planes",
            "1", labels=("service",),
        ).inc(service=self.name)
        self.view = self.plane.merged
        self.scenario_stats.setdefault(view.name, ServiceStats())
        if self.registry is not None:
            try:
                self.registry.get(view.name, view.version)
            except KeyError:
                self.registry.register(view)
            self.registry.deploy(
                f"{self.name}:{view.name}",
                view.name,
                view.version,
                description="hot deploy (live plane evolution)",
            )
        return report

    def _compute(self, rows, scenario, valid=None, route_info=None):
        if scenario is None:
            raise ValueError(
                f"multi-scenario service {self.name!r} needs scenario= "
                f"(one of {self.scenarios})"
            )
        return self.plane.query(
            scenario, rows, mode=self.mode, valid=valid, route_info=route_info
        )

    def _observe(self, latency_s, n_requests, scenario,
                 request_latencies_s=None):
        self.stats.observe(latency_s, n_requests)
        self.scenario_stats[scenario].observe(latency_s, n_requests)
        if request_latencies_s is not None:
            self.stats.observe_requests(request_latencies_s)
            self.scenario_stats[scenario].observe_requests(
                request_latencies_s
            )

    def _scenario_features(self, scenario: Optional[str]) -> Sequence[str]:
        if scenario is None:
            raise ValueError("feature_matrix needs scenario= on a "
                             "multi-scenario service")
        return self.plane.views[scenario].features

    def request_mixed(
        self,
        rows: Dict[str, np.ndarray],
        ingest: bool = True,
        route_info: Optional[Dict] = None,
    ) -> Dict[str, Dict[str, np.ndarray]]:
        """Serve one mixed multi-scenario batch with ONE device-routed
        dispatch.

        The batch carries a per-row ``__scenario__`` tag
        (:data:`SCENARIO_COL`, set by ``ShardRouter.submit``) beside the
        usual ``__valid__`` / ``__wait_us__`` meta columns.  The whole
        batch goes through :meth:`~repro_torch.core.scenario.ScenarioPlane.
        query_mixed`, and the answer comes back as ``{scenario: {feature:
        rows}}`` with each scenario's rows in submission order, bit for
        bit the per-group path's.

        Ingest keeps the per-group stream order: real rows are grouped by
        scenario (scenario order), each group sorted by (key, ts) and
        ingested group by group.  Stats and metrics are recorded per
        scenario (each request's latency sample is its queue wait plus
        this batch's wall time) and in the aggregate, where ``batches``
        counts ONE batch: the single dispatch.
        """
        if SCENARIO_COL not in rows:
            raise ValueError(
                f"request_mixed needs a {SCENARIO_COL!r} tag column "
                "(per-row scenario names; ShardRouter.submit sets it)"
            )
        tel = get_telemetry()
        t0 = tel.clock.now()
        tags = np.asarray(rows[SCENARIO_COL])
        valid = rows.get("__valid__")
        wait_us = rows.get("__wait_us__")
        data = {c: v for c, v in rows.items() if not c.startswith("__")}
        n_rows = len(next(iter(data.values())))
        vmask = (
            np.asarray(valid, bool)[:n_rows]
            if valid is not None
            else np.ones(n_rows, bool)
        )
        n_real = int(vmask.sum())
        with tel.tracer.span(
            "request", service=self.name, scenario="mixed", rows=n_real
        ):
            out = self.plane.query_mixed(
                data, tags, mode=self.mode, valid=vmask,
                route_info=route_info,
            )
            out = {s: {f: v.cpu().numpy() for f, v in feats.items()}
                   for s, feats in out.items()}
            if ingest and n_real:
                key_c = self.view.schema.key
                ts_c = self.view.schema.ts
                for s in self.scenarios:
                    m = vmask & (tags == s)
                    if not m.any():
                        continue
                    grp = {c: np.asarray(v)[m] for c, v in data.items()}
                    order = np.lexsort(
                        (np.asarray(grp[ts_c]), np.asarray(grp[key_c]))
                    )
                    self.store.ingest({c: v[order] for c, v in grp.items()})
        dt = tel.clock.now() - t0
        if wait_us is not None:
            waits_s = np.asarray(wait_us, np.float64)[:n_rows] / 1e6
        else:
            waits_s = np.zeros(n_rows, np.float64)
        agg_waits = waits_s[vmask]
        req_lat = agg_waits + dt
        m = tel.metrics
        sreq = m.counter(
            "service_requests_total", "requests served", "1",
            labels=("service", "scenario"),
        )
        m.histogram(
            "request_latency_seconds",
            "per-request latency (queue wait + batch wall)", "s",
            labels=("service",),
        ).observe_array(req_lat, service=self.name)
        if wait_us is not None and len(agg_waits):
            m.histogram(
                "queue_wait_seconds", "scheduler queue wait per request",
                "s", labels=("service",),
            ).observe_array(agg_waits, service=self.name)
        if valid is not None and n_rows:
            m.gauge(
                "batch_occupancy_ratio",
                "real rows / padded batch rows, last batch", "1",
                labels=("service",),
            ).set(n_real / n_rows, service=self.name)
        self.stats.observe(dt, n_real)
        self.stats.observe_requests(req_lat)
        for s in self.scenarios:
            msk = vmask & (tags == s)
            n_s = int(msk.sum())
            if not n_s:
                continue
            sreq.inc(n_s, service=self.name, scenario=s)
            st = self.scenario_stats[s]
            st.observe(dt, n_s)
            st.observe_requests(waits_s[msk] + dt)
        return out


class BatchScheduler:
    """Coalesce requests into fixed-shape batches (bucketed padding).

    With ``max_wait_us`` set, :meth:`next_batch` implements the real
    micro-batching deadline: it holds the queue open until either
    ``max_batch`` requests have accumulated or the *oldest* queued request
    has waited ``max_wait_us`` microseconds — whichever comes first — so a
    trickle of traffic still flushes partial batches within the latency
    budget.  Without it, any queued request flushes immediately (the
    legacy immediate-drain behaviour).

    Time is injectable (``now_us``) so schedulers are testable and
    replayable; real callers omit it and read the plane clock —
    ``repro_torch.obs.get_telemetry().clock`` — so a :class:`repro_torch.obs.FakeClock`
    installed via ``use_telemetry`` drives the scheduler, the registry,
    and every span from the same counter.
    """

    def __init__(
        self,
        buckets: Sequence[int] = (1, 4, 16, 64, 256),
        max_batch: Optional[int] = None,
        max_wait_us: Optional[int] = None,
    ):
        self.buckets = sorted(buckets)
        self.max_batch = max_batch
        self.max_wait_us = max_wait_us
        self.queue: List[Dict] = []
        self._arrival_us: List[int] = []
        self._injected_clock: Optional[bool] = None

    def _clock_us(self, now_us: Optional[int]) -> int:
        # a scheduler must live entirely on one clock: mixing an injected
        # test clock with the plane's monotonic clock would compare epochs
        # microseconds vs ~hours apart and either stall queued requests
        # forever or flush every batch instantly — fail loudly instead
        injected = now_us is not None
        if self._injected_clock is None:
            self._injected_clock = injected
        elif self._injected_clock != injected:
            raise ValueError(
                "BatchScheduler clock mode mixed: pass now_us on every "
                "call or on none (instance started with "
                f"{'injected' if self._injected_clock else 'monotonic'} time)"
            )
        return int(now_us) if injected else get_telemetry().clock.now_us()

    def submit(self, row: Dict, now_us: Optional[int] = None) -> None:
        self.queue.append(row)
        self._arrival_us.append(self._clock_us(now_us))

    def oldest_wait_us(self, now_us: Optional[int] = None) -> Optional[int]:
        if not self._arrival_us:
            return None
        return self._clock_us(now_us) - self._arrival_us[0]

    def next_batch(
        self,
        max_batch: Optional[int] = None,
        now_us: Optional[int] = None,
        flush: bool = False,
    ) -> Optional[Dict[str, np.ndarray]]:
        """Pop the next padded batch, or None.

        None means *empty queue* — or, under a ``max_wait_us`` deadline,
        *keep coalescing*: the queue is neither full (``max_batch``) nor
        expired yet.  ``flush=True`` overrides the deadline (shutdown /
        drain paths).
        """
        if not self.queue:
            return None
        max_batch = max_batch if max_batch is not None else self.max_batch
        if self.max_wait_us is not None and not flush:
            full = max_batch is not None and len(self.queue) >= max_batch
            expired = self.oldest_wait_us(now_us) >= self.max_wait_us
            if not (full or expired):
                return None
        n = len(self.queue)
        if max_batch:
            n = min(n, max_batch)
        bucket = next((b for b in self.buckets if b >= n), self.buckets[-1])
        n = min(n, bucket)
        pop_us = self._clock_us(now_us)
        rows, self.queue = self.queue[:n], self.queue[n:]
        arrivals, self._arrival_us = (
            self._arrival_us[:n], self._arrival_us[n:]
        )
        cols = {
            k: np.asarray([r[k] for r in rows])
            for k in rows[0]
        }
        waits = np.asarray(
            [max(pop_us - a, 0) for a in arrivals], np.int64
        )
        # pad to bucket by repeating the last row (masked out by caller)
        pad = bucket - n
        if pad:
            cols = {k: np.concatenate([v, np.repeat(v[-1:], pad, 0)])
                    for k, v in cols.items()}
            waits = np.concatenate([waits, np.repeat(waits[-1:], pad)])
        cols["__valid__"] = np.arange(bucket) < n
        cols["__wait_us__"] = waits
        m = get_telemetry().metrics
        m.counter(
            "padding_rows_total", "filler rows added to reach shape bucket",
            "1", labels=("layer",),
        ).inc(pad, layer="scheduler")
        m.gauge(
            "padding_waste_ratio", "filler rows / bucket rows, last batch",
            "1", labels=("layer",),
        ).set(pad / bucket, layer="scheduler")
        return cols


class ScoringService:
    """features -> signature embedding -> model -> score (fraud §3.3).

    ``handle`` builds one frontend sequence per request row: the row's
    feature vector and the signature embedding of its key, each zero-padded
    to ``d_model``, then zero patches up to the model's ``frontend_len``;
    one zero token follows, and the score is the sigmoid of the last
    position's logit 0.  The model (a :class:`~repro_torch.models.
    transformer.DecoderLM`) and ``embed_table`` live on the device the
    service runs on; the embedding and the model's cache-free forward run
    under ``torch.inference_mode()``.

    Each call records a ``score`` span with three children:
    ``score.features`` (host: the feature service's request, answers on
    the host), ``score.embed`` and ``score.model`` (device, fenced).
    """

    def __init__(self, feature_service: FeatureService, model,
                 embed_table: torch.Tensor, num_hashes: int = 2):
        from repro_torch.core.signature import signature_ids
        from repro_torch.kernels.signature.ops import signature_embed

        cfg = model.cfg
        widths = {"feature count": len(feature_service.view.features),
                  "embedding width": embed_table.shape[1]}
        for what, width in widths.items():
            if width > cfg.d_model:
                raise ValueError(
                    f"ScoringService: {what} {width} exceeds d_model "
                    f"{cfg.d_model}"
                )
        if cfg.frontend_len < 2:
            raise ValueError(
                "ScoringService: the model needs frontend_len >= 2 (the "
                "feature vector and the embedding)"
            )
        self.fs = feature_service
        self.model = model
        self.table = embed_table
        self.num_hashes = num_hashes
        self._signature_ids = signature_ids
        self._embed = signature_embed
        self._weights = torch.full(
            (num_hashes,), 1.0 / num_hashes, dtype=torch.float32,
            device=embed_table.device,
        )

    def _score(self, feats: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        """(B,) float32 scores from (B, d_model) features and embeddings:
        the model's cache-free forward, differentiable outside inference
        mode (the fraud example trains the scorer through it; ``handle``
        calls it under ``torch.inference_mode()``)."""
        from repro_torch.models.layers import logits_from_embedding

        model, cfg = self.model, self.model.cfg
        B = feats.shape[0]
        fe = torch.cat([feats[:, None, :], emb[:, None, :]], dim=1)
        fe = torch.nn.functional.pad(fe, (0, 0, 0, cfg.frontend_len - 2))
        batch = {
            "tokens": torch.zeros((B, 1), dtype=torch.int32, device=fe.device),
            "frontend_embeds": fe,
        }
        logits = logits_from_embedding(model.embed, model.last_hidden(batch),
                                       cfg)
        return torch.sigmoid(logits[:, -1, 0])

    def handle(self, rows: Dict[str, np.ndarray]) -> np.ndarray:
        """(B,) float32 fraud scores of the request ``rows``."""
        tracer = get_telemetry().tracer
        cfg = self.model.cfg
        dev = self.table.device
        n = len(next(iter(rows.values())))
        with tracer.span("score", rows=n):
            with tracer.span("score.features"):
                feats = self.fs.feature_matrix(rows)  # (B, F)
            # the store's own tensors stay outside inference mode: ingest
            # updates them in place later
            with torch.inference_mode():
                with tracer.span("score.embed", kind="device") as sp:
                    key = np.asarray(rows[self.fs.view.schema.key])
                    sig = self._signature_ids(
                        [torch.as_tensor(key.astype(np.int32), device=dev)],
                        bits=20,
                    )
                    emb = sp.fence(self._embed(self.table, sig, self._weights,
                                               num_hashes=self.num_hashes))
                with tracer.span("score.model", kind="device") as sp:
                    featvec = torch.nn.functional.pad(
                        torch.as_tensor(feats, dtype=torch.float32, device=dev),
                        (0, cfg.d_model - feats.shape[1]),
                    )
                    emb = torch.nn.functional.pad(
                        emb, (0, cfg.d_model - emb.shape[-1])
                    )
                    scores = sp.fence(self._score(featvec, emb))
            return scores.cpu().numpy()
