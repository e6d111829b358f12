"""CLI for the stress suite (the PyTorch port's twin of ``python -m
repro.stress``: the same flags and exit codes, plus ``--device``).

Smoke (CI gate — 16 views, 8 shards, 2 hot-deploy waves, fixed seed)::

    PYTHONPATH=src python -m repro_torch.stress --smoke [--device cpu]

Full sweep / custom runs::

    PYTHONPATH=src python -m repro_torch.stress --n 128 --seed 0
    PYTHONPATH=src python -m repro_torch.stress --smoke --force-fail gen_v003

Minimal repro (the harness emits these on verification failure)::

    PYTHONPATH=src python -m repro_torch.stress --repro --seed 0 --n 16 \\
        --view gen_v003 --data-rows 1200 --rows 150 [--host-routing]

Every run takes ``--device`` (default ``cuda``; ``cpu`` runs the plain
versions of the kernels).
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.stress.harness import run_repro, run_stress


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.stress",
        description="scenario-explosion stress suite",
    )
    ap.add_argument("--smoke", action="store_true",
                    help="CI smoke: N=16, fixed seed, 8 shards, 2 waves")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--profile", default="default")
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--waves", type=int, default=2)
    ap.add_argument("--wave-size", type=int, default=3)
    ap.add_argument("--rows", type=int, default=None,
                    help="primary stream rows (repro mode: verify prefix)")
    ap.add_argument("--verify-samples", type=int, default=2,
                    help="views verified per phase (rotating subset)")
    ap.add_argument("--force-fail", action="append", default=[],
                    metavar="VIEW",
                    help="force this view's verification to FAIL "
                         "(demonstrates shrink + minimal-repro emission)")
    ap.add_argument("--repro", action="store_true",
                    help="re-run one view's verification (emitted scripts)")
    ap.add_argument("--view", help="repro: generated view name")
    ap.add_argument("--data-rows", type=int, default=1200,
                    help="repro: full stream size the harness generated")
    ap.add_argument("--host-routing", action="store_true",
                    help="repro: verify under the host-routed oracle")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.repro:
        if not args.view:
            ap.error("--repro requires --view")
        rep = run_repro(
            seed=args.seed, n=args.n, profile=args.profile,
            view_name=args.view, data_rows=args.data_rows,
            rows=args.rows or args.data_rows,
            device_routing=not args.host_routing, num_shards=args.shards,
            device=args.device,
        )
        print(rep.summary())
        return 0 if rep.passed else 1

    n = 16 if args.smoke else args.n
    rows = args.rows or 1200
    report = run_stress(
        seed=args.seed, n=n, profile=args.profile,
        num_shards=args.shards, waves=args.waves,
        wave_size=args.wave_size, rows=rows,
        verify_samples=args.verify_samples,
        force_fail=tuple(args.force_fail),
        emit=print,
        device=args.device,
    )
    print(report.summary())
    return 0 if report.passed else 1


if __name__ == "__main__":
    sys.exit(main())
