"""Scenario explosion — the standing stress suite.

FeatInsight's headline claim is 100+ real-world scenarios served from one
platform with consistent offline/online feature computation; the
hand-written catalog has five.  This package closes the gap with a
seeded, deterministic generator (:mod:`repro_torch.stress.generate`) that
composes the full expr IR into N >= 100 feature views — byte-identical to
the reference package's generator for the same ``(seed, n, profile)`` —
and a churn harness (:mod:`repro_torch.stress.harness`) that deploys them
onto one sharded ``ScenarioPlane`` on the device, hot-deploys more in
waves, drives mixed-scenario traffic under both routing flavours, and
continuously samples the offline==online verification — shrinking any
failure down to a minimal, runnable repro script.

Entry points::

    python -m repro_torch.stress --smoke    # N=16, fixed seed, 8 shards
    python -m repro_torch.stress --n 128    # the full sweep
    python -m repro_torch.stress --smoke --device cpu   # plain versions
"""

from repro_torch.stress.generate import (  # noqa: F401
    NUM_ENTITIES,
    NUM_ITEMS,
    PROFILES,
    T_MAX,
    filter_table_knobs,
    gen_store_kwargs,
    gen_views,
    render_summary_md,
    stress_rng,
    summarize_views,
    view_fingerprint,
)
from repro_torch.stress.harness import (  # noqa: F401
    StressFailure,
    StressReport,
    run_stress,
)
