"""Check: training-set export must equal online replay row for row.

``python -m repro_torch.offline.check [--device cuda|cpu]`` exports a
point-in-time training set from the canonical multi-table view (LAST JOINs
+ a WINDOW UNION stream) over a synthetic history, then replays the same
history through live online stores — single-device and sharded — and
requires the exported rows to match the online answers at every label row
under the repo's f32 tolerance contract.  Exits 0 when every check
passes, 1 otherwise.

The online stores run with a *small* ring capacity on purpose: most label
rows are beyond the rings' retention horizon by the end of the replay,
which is exactly the regime the export path exists for — training labels
must not stop where ring capacity does.  The sizes are the reference
package's ``repro.offline.check``; it runs on the GPU unless asked for the
CPU (``--device cpu`` runs the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.data.synthetic import multitable_stream
from repro_torch.offline.export import export_training_set, verify_export
from repro_torch.scenarios import multi_table_view

NUM_ACCOUNTS = 16
NUM_MERCHANTS = 8
HIST_ROWS = 400
T_MAX = 20_000
CAPACITY = 16          # << rows/key: labels straddle the retention horizon
N_LABELS = 96
SHARD_COUNTS = (None, 4)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(7)
    view = multi_table_view()
    tables = multitable_stream(
        rng, HIST_ROWS, num_accounts=NUM_ACCOUNTS,
        num_merchants=NUM_MERCHANTS, t_max=T_MAX,
    )
    primary = tables["transactions"]
    secondary = {t: tables[t] for t in ("wires", "accounts", "merchants")}

    training = export_training_set(
        view, primary, n=N_LABELS, seed=3, secondary=secondary,
        device=args.device,
    )
    rows_per_key = HIST_ROWS / NUM_ACCOUNTS
    print(training.describe())
    print(
        f"history: {HIST_ROWS} rows over {NUM_ACCOUNTS} accounts "
        f"(~{rows_per_key:.0f}/key), online capacity {CAPACITY}/key "
        "-> label rows reach beyond the retention horizon"
    )

    ok = True
    for shards in SHARD_COUNTS:
        check = verify_export(
            view, primary, training,
            num_keys=NUM_ACCOUNTS,
            capacity=CAPACITY,
            secondary=secondary,
            secondary_num_keys={"merchants": NUM_MERCHANTS},
            num_shards=shards,
            device=args.device,
        )
        print(check.summary())
        ok = ok and check.passed
    if not ok:
        print("export-vs-replay check FAILED", file=sys.stderr)
        return 1
    print("training-set export matches online replay row for row: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
