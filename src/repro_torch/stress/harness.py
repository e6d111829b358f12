"""Deploy-churn-verify harness over a generated scenario plane.

One run = the paper's serving story at generator scale:

1. **deploy** — N generated views land on ONE sharded ``ScenarioPlane``
   via ``FeatureService.build_multi`` (a held-back tail is reserved for
   churn);
2. **churn** — ``hot_deploy`` waves push the held-back views onto the
   LIVE plane, alternating between history-synthesis-only migrations and
   migrations fed a :class:`~repro_torch.offline.backfill.BackfillSource`
   rebuilt from the exact ingest log — every wave must report an exact
   migration.  A no-backfill wave that draws a view with unsynthesizable
   new lanes (hash/signature) must refuse LOUDLY naming the backfill
   remedy; the harness then retries that view with the exact-history
   source (the documented contract, exercised, not worked around);
3. **traffic** — mixed-scenario batches flow through ``ShardRouter`` /
   ``request_mixed`` under BOTH ``device_routing`` flavours, and each
   phase runs a fused-vs-host parity probe that must match bit-for-bit;
4. **verify** — a seeded rotating subset of live views replays through
   ``verify_view`` (offline==online, alternating routing flavours), plus
   a plane == dedicated-store spot check: one view's answers against a
   fresh single-view store replaying the identical ingest log must be
   bit-identical;
5. **shrink** — any failing check re-runs the failing view in isolation
   on a shrinking data prefix and emits a minimal, runnable repro script
   naming the seed and the view spec (``python -m repro_torch.stress
   --repro``).

Every sampling decision (traffic tags, verify rotation) flows from the
same named generator as ``gen_views`` — a stress run is reproducible
from ``(seed, n, profile)`` alone.  The same protocol, arguments, sampling
order and messages as the reference package's ``repro.stress.harness``;
every store, replay and probe lives on ``device`` (default ``"cuda"``),
and answers are copied to the host and compared there with
``np.array_equal``, as the reference compares them.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.consistency import ConsistencyReport, verify_view
from repro_torch.core.online import OnlineFeatureStore
from repro_torch.core.view import FeatureRegistry, FeatureView, render_sql
from repro_torch.data.synthetic import STRESS_DB, stress_stream
from repro_torch.offline.backfill import BackfillSource
from repro_torch.serve.router import ShardRouter
from repro_torch.serve.service import BatchScheduler, FeatureService
from repro_torch.stress.generate import (
    NUM_ENTITIES,
    NUM_ITEMS,
    T_MAX,
    filter_table_knobs,
    gen_store_kwargs,
    gen_views,
    stress_rng,
)

__all__ = ["StressFailure", "StressReport", "run_stress", "run_repro"]


@dataclasses.dataclass
class StressFailure:
    view: str
    stage: str                    # deploy | parity | spot | verify
    detail: str
    shrunk_rows: Optional[int] = None
    repro_path: Optional[str] = None

    def summary(self) -> str:
        extra = ""
        if self.shrunk_rows is not None:
            extra = f" (shrunk to {self.shrunk_rows} rows)"
        if self.repro_path:
            extra += f" repro: {self.repro_path}"
        return f"[{self.stage}] {self.view}: {self.detail}{extra}"


@dataclasses.dataclass
class StressReport:
    seed: int
    n: int
    profile: str
    num_shards: int
    deployed: int
    waves_survived: int
    requests: int
    request_wall_s: float
    deploy_wall_s: float
    parity_batches: int
    verified: List[str]
    spot_checked: List[str]
    failures: List[StressFailure]

    @property
    def passed(self) -> bool:
        return not self.failures

    @property
    def qps(self) -> float:
        return self.requests / self.request_wall_s if self.request_wall_s else 0.0

    def summary(self) -> str:
        flag = "PASS" if self.passed else "FAIL"
        lines = [
            f"[{flag}] stress seed={self.seed} n={self.n} "
            f"profile={self.profile} shards={self.num_shards}: "
            f"{self.deployed} views deployed "
            f"({self.waves_survived} hot-deploy waves), "
            f"{self.requests} requests at {self.qps:.0f} req/s, "
            f"{self.parity_batches} flavour-parity probes, "
            f"{len(self.verified)} verified "
            f"({len(self.spot_checked)} spot checks)"
        ]
        lines += ["  " + f.summary() for f in self.failures]
        return "\n".join(lines)


def _sorted_batch(cols: Dict[str, np.ndarray], key: str, ts: str) -> Dict:
    order = np.lexsort((cols[ts], cols[key]))
    return {c: np.asarray(v)[order] for c, v in cols.items()}


def _slice(cols: Dict[str, np.ndarray], idx) -> Dict[str, np.ndarray]:
    return {c: np.asarray(v)[idx] for c, v in cols.items()}


def _host(v) -> np.ndarray:
    """An answer column on the host (a device tensor is copied back)."""
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _rotate(seq: Sequence[str], k: int, count: int) -> List[str]:
    if not seq:
        return []
    k = k % len(seq)
    doubled = list(seq[k:]) + list(seq[:k])
    return doubled[: min(count, len(seq))]


def _repro_script(*, seed: int, n: int, profile: str, view: FeatureView,
                  data_rows: int, rows: int, device_routing: bool,
                  detail: str) -> str:
    spec = "\n".join(
        f"#   {render_sql(f, e, view.schema, view.database)}"
        for f, e in view.features.items()
    )
    flavour = "" if device_routing else " --host-routing"
    return (
        "#!/usr/bin/env bash\n"
        f"# Minimal repro: stress view {view.name} (v{view.version}) "
        f"failed offline==online verification.\n"
        f"#   seed={seed} n={n} profile={profile} "
        f"flavour={'device' if device_routing else 'host'}\n"
        f"#   {detail}\n"
        "# View spec:\n"
        f"{spec}\n"
        f"PYTHONPATH=src python -m repro_torch.stress --repro "
        f"--seed {seed} --n {n} --profile {profile} "
        f"--view {view.name} --data-rows {data_rows} --rows {rows}"
        f"{flavour}\n"
    )


def _verify_one(view: FeatureView, tabs: Dict[str, Dict], rows: int, *,
                capacity: int, num_shards: Optional[int],
                device_routing: bool, device):
    """verify_view over a data prefix — the shrinker's unit of work."""
    prim = _slice(tabs["events"], slice(0, rows))
    tmax = int(prim["ts"][-1])
    secondary = {}
    sec_nk = {}
    for t in view.tables[1:]:
        sch = STRESS_DB.table(t)
        keep = np.asarray(tabs[t][sch.ts]) <= tmax
        secondary[t] = _slice(tabs[t], keep)
        if t == "items":
            sec_nk["items"] = NUM_ITEMS
    return verify_view(
        view,
        prim,
        num_keys=NUM_ENTITIES,
        capacity=capacity,
        secondary=secondary or None,
        secondary_num_keys=sec_nk or None,
        num_shards=num_shards,
        device_routing=device_routing,
        device=device,
    )


def run_stress(
    seed: int = 0,
    n: int = 16,
    profile: str = "default",
    *,
    num_shards: int = 8,
    waves: int = 2,
    wave_size: int = 3,
    rows: int = 1200,
    warm_frac: float = 0.6,
    batch: int = 64,
    verify_samples: int = 2,
    verify_rows: int = 480,
    force_fail: Sequence[str] = (),
    repro_dir: Optional[str] = ".",
    emit: Optional[Callable[[str], None]] = None,
    device="cuda",
) -> StressReport:
    """One full stress run; see the module docstring for the protocol.

    ``force_fail`` names views whose verification verdict is forced to
    FAIL — the switch that demonstrates the shrink-and-repro machinery
    end to end without planting a real bug.  Every store (the plane, the
    spot check's dedicated store, each verification replay) is built on
    ``device``.
    """
    say = emit or (lambda s: None)
    device = resolve_device(device)
    views = gen_views(seed, n, profile)
    kwargs = gen_store_kwargs(seed, n, profile)
    n_held = waves * wave_size
    if n_held >= n:
        raise ValueError(
            f"waves*wave_size={n_held} must leave initial views (n={n})"
        )
    initial, pending = views[: n - n_held], views[n - n_held:]
    if rows > T_MAX:
        raise ValueError(f"rows={rows} exceeds the unique-ts budget {T_MAX}")
    tabs = stress_stream(
        stress_rng(seed, n, profile, "data"),
        rows,
        num_entities=NUM_ENTITIES,
        num_items=NUM_ITEMS,
        t_max=T_MAX,
    )
    rng = stress_rng(seed, n, profile, "harness")
    failures: List[StressFailure] = []
    verified: List[str] = []
    spot_checked: List[str] = []
    parity_batches = 0
    requests = 0
    request_wall = 0.0

    # -- deploy ------------------------------------------------------------
    registry = FeatureRegistry()
    for v in initial:
        registry.register(v)
    t0 = time.perf_counter()
    svc = FeatureService.build_multi(
        "stress_plane",
        initial,
        num_keys=NUM_ENTITIES,
        registry=registry,
        sharded=True,
        num_shards=num_shards,
        device=device,
        **filter_table_knobs(kwargs, initial),
    )
    deploy_wall = time.perf_counter() - t0
    plane = svc.plane
    say(f"deployed {len(initial)} views on {num_shards} shards "
        f"in {deploy_wall:.1f}s")
    router = ShardRouter(svc, BatchScheduler(max_batch=batch), ingest=False)

    # Ingest log: the harness owns every state mutation (the router runs
    # ingest=False), so a dedicated store can replay the identical stream
    # for the bit-identity spot check, and BackfillSource waves are fed
    # exactly the ingested history.
    log: List[Tuple[str, Dict[str, np.ndarray]]] = []

    def ingest(table: str, cols: Dict[str, np.ndarray]) -> None:
        if not len(next(iter(cols.values()))):
            return
        sch = STRESS_DB.table(table)
        b = _sorted_batch(cols, sch.key, sch.ts)
        if table == STRESS_DB.primary.name:
            plane.ingest(b)
        else:
            plane.ingest_table(table, b)
        log.append((table, b))

    seen_tables = set()

    def ingest_new_tables() -> None:
        """Feed full history into tables the plane just started tracking
        (a hot-deployed view can reference a stream no prior view did)."""
        for t in plane.store._sec_names:
            if t not in seen_tables:
                seen_tables.add(t)
                ingest(t, tabs[t])

    ingest_new_tables()
    i_warm = int(rows * warm_frac)
    ingest("events", _slice(tabs["events"], slice(0, i_warm)))

    chunks = np.array_split(np.arange(i_warm, rows), waves + 1)

    def backfill_from_log() -> BackfillSource:
        hist: Dict[str, Dict[str, np.ndarray]] = {}
        for t, b in log:
            if t not in hist:
                hist[t] = {c: [v] for c, v in b.items()}
            else:
                for c, v in b.items():
                    hist[t][c].append(v)
        return BackfillSource(
            STRESS_DB,
            {t: {c: np.concatenate(vs) for c, vs in cols.items()}
             for t, cols in hist.items()},
        )

    def flavour_parity(idx: np.ndarray, phase: int) -> None:
        """Fused on-mesh answers vs the host-routed oracle, bit-for-bit,
        on identical read-only state."""
        nonlocal parity_batches
        scens = _rotate(plane.scenarios, 2 * phase, 4)
        probe = _slice(tabs["events"], idx[: min(64, len(idx))])
        m = len(probe["ts"])
        tags = np.array([scens[i % len(scens)] for i in range(m)])
        dev = plane.query_mixed(probe, tags)
        store = plane.store
        store.device_routing = False
        try:
            for s in scens:
                sel = tags == s
                if not sel.any():
                    continue
                host = plane.query(s, _slice(probe, sel))
                for f, hv in host.items():
                    dv = dev[s][f]
                    if not np.array_equal(_host(dv), _host(hv)):
                        failures.append(StressFailure(
                            view=s, stage="parity",
                            detail=f"feature {f!r}: fused != host oracle "
                                   f"(phase {phase})",
                        ))
        finally:
            store.device_routing = True
        parity_batches += 1

    def route_traffic(idx: np.ndarray, phase: int) -> None:
        """Mixed-scenario router traffic: the bulk under the fused device
        flavour, a tail slice re-routed through the host oracle."""
        nonlocal requests, request_wall
        scens = plane.scenarios
        cols = _slice(tabs["events"], idx)
        tags = [scens[int(t)] for t in rng.integers(len(scens), size=len(idx))]
        t0 = time.perf_counter()
        for i in range(len(idx)):
            router.submit({c: v[i] for c, v in cols.items()},
                          scenario=tags[i])
        router.drain()
        host_m = min(32, len(idx))
        host_scens = _rotate(scens, phase, 2)
        plane.store.device_routing = False
        try:
            for i in range(host_m):
                router.submit({c: v[i] for c, v in cols.items()},
                              scenario=host_scens[i % len(host_scens)])
            router.drain()
        finally:
            plane.store.device_routing = True
        request_wall += time.perf_counter() - t0
        requests += len(idx) + host_m

    def spot_check(phase: int) -> None:
        """plane == dedicated store, bit-for-bit: replay the ingest log
        into a fresh single-view store and compare one view's answers."""
        scen = _rotate(plane.scenarios, phase, 1)[0]
        view = plane.views[scen]
        dedicated = OnlineFeatureStore.create(
            view,
            num_keys=NUM_ENTITIES,
            device=device,
            **filter_table_knobs(kwargs, [view]),
        )
        ded_tables = set(dedicated._sec_names)
        for t, b in log:
            if t == STRESS_DB.primary.name:
                dedicated.ingest(b)
            elif t in ded_tables:
                dedicated.ingest_table(t, b)
        n_ev = len(tabs["events"]["ts"])
        idx = rng.choice(n_ev, size=min(48, n_ev), replace=False)
        probe = _slice(tabs["events"], np.sort(idx))
        a = plane.query(scen, probe)
        b = dedicated.query(probe)
        for f in view.features:
            if not np.array_equal(_host(a[f]), _host(b[f])):
                failures.append(StressFailure(
                    view=scen, stage="spot",
                    detail=f"feature {f!r}: plane != dedicated store "
                           f"(phase {phase})",
                ))
                return
        spot_checked.append(scen)

    def shrink(view: FeatureView, flag: bool, detail: str,
               forced: bool) -> StressFailure:
        """Re-run the failing view in isolation on a halving data prefix,
        then emit the minimal runnable repro."""
        def fails(r: int) -> bool:
            if forced:
                return True
            return not _verify_one(
                view, tabs, r, capacity=kwargs["capacity"],
                num_shards=num_shards, device_routing=flag, device=device,
            ).passed

        r = min(verify_rows, rows)
        while r > 64 and fails(r // 2):
            r //= 2
        script = _repro_script(
            seed=seed, n=n, profile=profile, view=view,
            data_rows=rows, rows=r, device_routing=flag, detail=detail,
        )
        path = None
        if repro_dir is not None:
            path = os.path.join(repro_dir, f"stress_repro_{view.name}.sh")
            with open(path, "w") as fh:
                fh.write(script)
        return StressFailure(
            view=view.name, stage="verify", detail=detail,
            shrunk_rows=r, repro_path=path,
        )

    verify_i = 0

    def sampled_verify(phase: int) -> None:
        """Seeded rotating subset, alternating routing flavours."""
        nonlocal verify_i
        for s in _rotate(plane.scenarios, phase * verify_samples,
                         verify_samples):
            view = plane.views[s]
            flag = verify_i % 2 == 0
            verify_i += 1
            forced = view.name in force_fail
            rep = _verify_one(
                view, tabs, min(verify_rows, rows),
                capacity=kwargs["capacity"], num_shards=num_shards,
                device_routing=flag, device=device,
            )
            if rep.passed and not forced:
                verified.append(f"{s}:{rep.mode}")
                say(f"  verify {rep.summary()}")
            else:
                detail = (
                    "forced failure (--force-fail)" if forced else
                    f"max_abs={rep.max_abs_err:.3e} "
                    f"max_rel={rep.max_rel_err:.3e} mode={rep.mode}"
                )
                failures.append(shrink(view, flag, detail, forced))
                say(f"  verify FAIL {s}: {detail}")

    # -- the churn loop ----------------------------------------------------
    waves_survived = 0
    for phase in range(waves + 1):
        say(f"phase {phase}: {len(plane.scenarios)} live scenarios, "
            f"{len(chunks[phase])} traffic rows")
        flavour_parity(chunks[phase], phase)
        route_traffic(chunks[phase], phase)
        ingest("events", _slice(tabs["events"], chunks[phase]))
        spot_check(phase)
        sampled_verify(phase)
        if phase < waves:
            wave, pending = pending[:wave_size], pending[wave_size:]
            use_backfill = phase % 2 == 1
            src = backfill_from_log() if use_backfill else None
            refused = 0
            for v in wave:
                knobs = filter_table_knobs(
                    {k: kwargs[k] for k in
                     ("table_capacity", "table_ttl",
                      "secondary_num_keys")},
                    list(plane.views.values()) + [v],
                )
                t0 = time.perf_counter()
                try:
                    mig = svc.hot_deploy(v, backfill=src, **knobs)
                except ValueError as e:
                    # no-backfill waves are EXPECTED to hit the loud
                    # refusal for views whose new lanes (hash/signature,
                    # aged-out rows) can't be synthesized from stored f32
                    # history — that refusal IS the migration contract.
                    # Retry with the exact-history source; anything else
                    # (or a refusal that names no backfill remedy, or one
                    # on a wave that already HAD backfill) is a failure.
                    if src is not None or "backfill" not in str(e):
                        failures.append(StressFailure(
                            view=v.name, stage="deploy",
                            detail=f"hot-deploy raised "
                                   f"(backfill={use_backfill}): {e}",
                        ))
                        deploy_wall += time.perf_counter() - t0
                        continue
                    refused += 1
                    mig = svc.hot_deploy(
                        v, backfill=backfill_from_log(), **knobs)
                deploy_wall += time.perf_counter() - t0
                if not mig.exact:
                    failures.append(StressFailure(
                        view=v.name, stage="deploy",
                        detail=f"inexact hot-deploy migration "
                               f"(backfill={use_backfill}): "
                               f"{'; '.join(mig.notes) or mig.diff_summary}",
                    ))
            ingest_new_tables()
            waves_survived += 1
            say(f"  wave {phase + 1}: +{len(wave)} views "
                f"(backfill={use_backfill}, "
                f"refused-then-backfilled={refused})")

    return StressReport(
        seed=seed, n=n, profile=profile, num_shards=num_shards,
        deployed=len(plane.scenarios), waves_survived=waves_survived,
        requests=requests, request_wall_s=request_wall,
        deploy_wall_s=deploy_wall, parity_batches=parity_batches,
        verified=verified, spot_checked=spot_checked, failures=failures,
    )


def run_repro(*, seed: int, n: int, profile: str, view_name: str,
              data_rows: int, rows: int, device_routing: bool,
              num_shards: int = 8, device="cuda") -> ConsistencyReport:
    """Re-run one generated view's verification exactly as the harness
    did — the target of the emitted minimal repro script."""
    device = resolve_device(device)
    views = {v.name: v for v in gen_views(seed, n, profile)}
    if view_name not in views:
        raise KeyError(f"no generated view {view_name!r} at "
                       f"(seed={seed}, n={n}, profile={profile!r})")
    tabs = stress_stream(
        stress_rng(seed, n, profile, "data"),
        data_rows,
        num_entities=NUM_ENTITIES,
        num_items=NUM_ITEMS,
        t_max=T_MAX,
    )
    kwargs = gen_store_kwargs(seed, n, profile)
    return _verify_one(
        views[view_name], tabs, min(rows, data_rows),
        capacity=kwargs["capacity"], num_shards=num_shards,
        device_routing=device_routing, device=device,
    )
