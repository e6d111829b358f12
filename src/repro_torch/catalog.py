"""Generated feature catalog — the repo's always-in-sync docs layer.

Feature stores live or die by discoverability: a feature that isn't
documented gets rebuilt (slightly differently) by the next team, which is
exactly the drift FeatInsight's lineage/verification machinery exists to
prevent.  So the catalog is *generated from the code*: every canonical
scenario view in :mod:`repro_torch.scenarios` renders itself via
:meth:`~repro_torch.core.view.FeatureView.describe` (source tables,
per-column window/agg lineage, rendered SQL, deploy history), and the
check regenerates and diffs so ``docs/CATALOG_TORCH.md`` cannot go stale.

Usage::

    python -m repro_torch.catalog          # (re)write docs/CATALOG_TORCH.md
    python -m repro_torch.catalog --check  # exit 1 if it is stale

Output is deterministic (no wall-clock anywhere) — that's what makes the
regenerate-and-diff gate possible.  It is the reference package's
``docs/CATALOG.md`` except for the header's two names and the ``Run:``
lines, which name this package's commands; the tests hold the two equal
up to exactly those lines.  Building it needs no device.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

from repro_torch.core.view import FeatureRegistry

CATALOG_PATH = (
    pathlib.Path(__file__).resolve().parents[2] / "docs" / "CATALOG_TORCH.md"
)

_HEADER = """\
# Feature catalog

> **Generated** by `python -m repro_torch.catalog` from `src/repro_torch/scenarios.py`
> — do not edit by hand.  CI runs `python -m repro_torch.catalog --check` and
> fails when this file is stale.

Every canonical scenario deployed by this reproduction, with its feature
views rendered from the live definitions: source tables and their roles,
per-feature window/aggregation lineage, the OpenMLDB-flavoured SQL, and
the services that deploy each view.
"""


def build_catalog() -> str:
    """Render the full catalog markdown (deterministic)."""
    from repro_torch.scenarios import GENERATED, SCENARIOS

    registry = FeatureRegistry()
    sections = [_HEADER]
    for scen in SCENARIOS.values():
        views = scen.views()
        for v in views:
            registry.register(v)
            if len(views) == 1:
                registry.deploy(f"{scen.name}_svc", v.name, v.version)
            else:
                # the multi-scenario plane deploys every view under one
                # service, tagged per scenario (MultiScenarioService);
                # views the scenario declares as hot-deployed carry the
                # hot-deploy description — the catalog's deploy history
                # records live plane evolutions
                registry.deploy(
                    f"{scen.name}:{v.name}", v.name, v.version,
                    description=(
                        "hot deploy (live plane evolution)"
                        if v.name in scen.hot_deployed
                        else ""
                    ),
                )
            if v.name in scen.exported:
                # the scenario's example also exports a point-in-time
                # training set from these definitions
                # (repro_torch.offline.export_training_set records the same
                # lineage when handed a registry)
                registry.deploy(
                    f"export:{v.name}", v.name, v.version,
                    description=(
                        "point-in-time training-set export "
                        "(offline bridge)"
                    ),
                )
        sections += [
            f"## {scen.title} (`{scen.name}`)",
            "",
            scen.description,
            "",
            f"Run: `{scen.run}`",
            "",
        ]
        if len(views) > 1:
            shared = sorted(
                t
                for t in {tt for v in views for tt in v.tables}
                if sum(t in v.tables for v in views) > 1
            )
            sections += [
                f"Deployed together on one `ScenarioPlane` "
                f"({len(views)} views, one store/mesh); shared tables "
                f"ingested once: {', '.join(f'`{t}`' for t in shared)}.",
                "",
            ]
        for v in views:
            sections.append(v.describe(registry))
    # Generated scenario families render a scale-aware structural census
    # (agg/window/union/join counts + sample entries) instead of 100+
    # full pages — still deterministic, so the staleness gate holds.
    for fam in GENERATED.values():
        sections += [
            f"## {fam.title} (`{fam.name}`)",
            "",
            fam.description,
            "",
            f"Run: `{fam.run}`",
            "",
            fam.summary_md(),
            "",
        ]
    return "\n".join(sections).rstrip() + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="(re)generate or verify docs/CATALOG_TORCH.md"
    )
    ap.add_argument(
        "--check",
        action="store_true",
        help="regenerate-and-diff: exit 1 if docs/CATALOG_TORCH.md is stale",
    )
    ap.add_argument(
        "--out", default=str(CATALOG_PATH), help="output path override"
    )
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)
    fresh = build_catalog()
    if args.check:
        current = out.read_text() if out.exists() else ""
        if current != fresh:
            print(
                f"STALE: {out} does not match the generated catalog; "
                "run `python -m repro_torch.catalog`",
                file=sys.stderr,
            )
            return 1
        print(f"catalog up to date: {out}")
        return 0
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(fresh)
    print(f"wrote {out} ({len(fresh.splitlines())} lines)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
