"""Data import + synthetic workloads (FeatInsight §3.1 step 1)."""

from repro_torch.data.ingest import (
    insert_rows, load_csv, load_npz, load_table, validate,
)
from repro_torch.data.synthetic import (
    FRAUD_SCHEMA, RECO_SCHEMA, fraud_stream, lm_stream, reco_stream,
)

__all__ = [
    "insert_rows", "load_csv", "load_npz", "load_table", "validate",
    "FRAUD_SCHEMA", "RECO_SCHEMA", "fraud_stream", "lm_stream", "reco_stream",
]
