"""Scenario explosion — the stress suite's seeded view generator.

FeatInsight's headline claim is 100+ real-world scenarios served from one
platform with consistent offline/online feature computation; the
hand-written catalog has five.  :mod:`repro_torch.stress.generate`
composes the full expr IR into N >= 100 deterministic feature views —
byte-identical to the reference package's generator for the same
``(seed, n, profile)`` — and renders the census the feature catalog
prints for them.

The churn harness that deploys those views onto one sharded plane and
its ``python -m repro_torch.stress`` entry point are not part of this
package yet; only the generator is.
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
