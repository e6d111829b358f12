"""Online feature service — FeatInsight §3.1 step 4 — and the §3.3
scoring service on top of it.

``FeatureService`` is the paper's deployment unit: a named, versioned view
bound to an online store, answering request rows with feature vectors
under a latency budget.  ``BatchScheduler`` is the serving loop's
micro-batcher: requests coalesce up to ``max_batch`` or ``max_wait_us``
(whichever first) and are padded to a fixed batch shape.
``ScoringService`` turns request rows into fraud scores: features, a
signature embedding of the key, then the model.

The single-scenario slice of the reference package's ``repro.serve.
service`` (``MultiScenarioService`` is not ported yet).  Answers come back
as numpy arrays on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.online import OnlineFeatureStore
from repro_torch.core.view import FeatureRegistry, FeatureView
from repro_torch.obs import get_telemetry

__all__ = ["ServiceStats", "FeatureService", "BatchScheduler", "ScoringService"]


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
        to default from); answers equal the single-device store's.
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

    def request(self, rows: Dict[str, np.ndarray],
                ingest: bool = True,
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

        ``route_info`` (dict, filled in place) surfaces the store's
        per-shard routing counts to the caller — the router's skew
        histograms read them instead of re-hashing keys.
        """
        tel = get_telemetry()
        t0 = tel.clock.now()
        valid = rows.get("__valid__")
        wait_us = rows.get("__wait_us__")
        rows = {c: v for c, v in rows.items() if not c.startswith("__")}
        n_rows = len(next(iter(rows.values())))
        n_real = int(np.asarray(valid, bool).sum()) if valid is not None else n_rows
        with tel.tracer.span(
            "request", service=self.name, scenario="", rows=n_real,
        ):
            out = self.store.query(
                rows, mode=self.mode, valid=valid, route_info=route_info
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
        ).inc(n_real, service=self.name, scenario="")
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
        self.stats.observe(dt, n_real)
        self.stats.observe_requests(req_lat)
        return out

    def feature_matrix(self, rows: Dict[str, np.ndarray]) -> np.ndarray:
        """(B, F) float32 features of ``rows`` in ``view.features`` order,
        without ingesting them."""
        out = self.request(rows, ingest=False)
        return np.stack([out[f] for f in self.view.features], axis=-1)


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
        """(B,) float32 scores from (B, d_model) features and embeddings."""
        cfg = self.model.cfg
        B = feats.shape[0]
        fe = torch.cat([feats[:, None, :], emb[:, None, :]], dim=1)
        fe = torch.nn.functional.pad(fe, (0, 0, 0, cfg.frontend_len - 2))
        batch = {
            "tokens": torch.zeros((B, 1), dtype=torch.int32, device=fe.device),
            "frontend_embeds": fe,
        }
        logits = self.model(batch)
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
