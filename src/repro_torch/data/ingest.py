"""Data import — FeatInsight §3.1 step 1 ("Import Data").

The paper ingests CSV, Hive, SQL INSERT/LOAD DATA, Parquet and single-row
data.  In this container the implemented adapters are:

* ``load_csv``    — CSV files (stdlib csv; schema-driven typing),
* ``load_npz``    — columnar .npz archives (the offline-export format),
* ``insert_rows`` — single/multi row INSERT-equivalent (list of dicts),
* ``load_table``  — format dispatcher (the "Data Import" button).

Hive/Parquet adapters require external services / libraries not present
offline; the dispatcher raises a clear error naming the missing backend so
a deployment can drop in an adapter without touching call sites.

All adapters return a ``columns`` dict (``{name: np.ndarray}``) validated
against a :class:`repro_torch.core.storage.TableSchema` — key/ts as int32,
numeric lanes f32, categorical lanes int32 — the exact layout the offline
engine and online store consume.  The loaders are host-side numpy: the
columns go to the device when a store ingests them.

The reference package's ``repro.data.ingest``, with the same typing (CSV
parsed through float64, then cast) and the same refusals.  A float32
column written as ``repr(float(v))`` (its exact float64 widening) loads
back bit for bit.
"""

from __future__ import annotations

import csv
import io
import pathlib
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Union

import numpy as np

from repro_torch.core.storage import TableSchema

__all__ = ["load_csv", "load_npz", "insert_rows", "load_table", "validate"]

PathLike = Union[str, pathlib.Path]


def _typed(schema: TableSchema, name: str, vals: Sequence) -> np.ndarray:
    if name == schema.key or name == schema.ts:
        return np.asarray(vals, np.int32)
    if name in schema.categorical:
        return np.asarray(vals, np.int32)
    return np.asarray(vals, np.float32)


def validate(schema: TableSchema, columns: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Type-check and coerce a columns dict against the schema."""
    need = (schema.key, schema.ts) + tuple(schema.numeric) + tuple(schema.categorical)
    missing = [c for c in need if c not in columns]
    if missing:
        raise ValueError(f"table {schema.name!r}: missing columns {missing}")
    n = len(columns[schema.key])
    out: Dict[str, np.ndarray] = {}
    for c in need:
        arr = _typed(schema, c, columns[c])
        if len(arr) != n:
            raise ValueError(
                f"column {c!r} has {len(arr)} rows, key has {n}"
            )
        out[c] = arr
    return out


def load_csv(
    path_or_text: Union[PathLike, io.StringIO],
    schema: TableSchema,
) -> Dict[str, np.ndarray]:
    """CSV -> columns dict. Header row must name the schema columns."""
    if isinstance(path_or_text, io.StringIO):
        fh = path_or_text
        rows = list(csv.DictReader(fh))
    else:
        with open(path_or_text, newline="") as fh:
            rows = list(csv.DictReader(fh))
    if not rows:
        raise ValueError("empty CSV")
    cols: Dict[str, List] = {c: [] for c in rows[0].keys()}
    for r in rows:
        for c, v in r.items():
            cols[c].append(v)
    typed = {c: _typed(schema, c, np.asarray(v, np.float64)) for c, v in cols.items()}
    return validate(schema, typed)


def load_npz(path: PathLike, schema: TableSchema) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return validate(schema, {k: z[k] for k in z.files})


def insert_rows(
    rows: Iterable[Mapping[str, float]],
    schema: TableSchema,
    into: Optional[Dict[str, np.ndarray]] = None,
) -> Dict[str, np.ndarray]:
    """INSERT-equivalent: append rows (dicts) to an existing columns dict."""
    rows = list(rows)
    cols = {c: [r[c] for r in rows] for c in rows[0].keys()}
    new = validate(schema, {c: np.asarray(v) for c, v in cols.items()})
    if into is None:
        return new
    return {
        c: np.concatenate([np.asarray(into[c]), new[c]]) for c in new
    }


_BACKENDS = ("csv", "npz", "rows")


def load_table(
    source, schema: TableSchema, format: str = "csv"
) -> Dict[str, np.ndarray]:
    """Format dispatcher — the paper's multi-format "Data Import"."""
    if format == "csv":
        return load_csv(source, schema)
    if format == "npz":
        return load_npz(source, schema)
    if format == "rows":
        return insert_rows(source, schema)
    if format in ("hive", "parquet", "sql"):
        raise NotImplementedError(
            f"{format!r} import requires an external backend not available "
            f"offline; implement a {format}->columns adapter and register it "
            f"here (available: {_BACKENDS})"
        )
    raise ValueError(f"unknown format {format!r}; available: {_BACKENDS}")
