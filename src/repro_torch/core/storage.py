"""Per-key time-series ring storage on device tensors.

The invariant the paper's skiplist buys — per-key, timestamp-ordered,
O(1)-appendable recent history — as a structure of arrays:

  ts    : (K, C)     int32   per-key ring of row timestamps
  vals  : (K, C, F)  float32 per-key ring of encoded row payloads
  cursor: (K,)       int32   rows ever written per key (slot = cursor % C)

The same layout and semantics as the reference package's
``repro.core.storage``.  Unlike the reference's functional scatters,
:func:`ring_ingest` updates the tensors **in place** (a deployment-sized
ring is gigabytes; a functional copy per batch would double it).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Tuple

import torch

from repro_torch.core.hashing import fold_hash

__all__ = [
    "TableSchema", "Database", "RowCodec", "RingStore",
    "ring_init", "ring_ingest", "ring_gather",
]

TS_EMPTY = -2147483648


@dataclasses.dataclass(frozen=True)
class TableSchema:
    """Schema of a raw source table.

    numeric: fixed-width f32 fields stored verbatim.
    categorical: variable-width fields, hashed to `cat_bits`-bit signatures
    at ingest (they arrive as arbitrary int ids).
    """

    name: str
    key: str
    ts: str
    numeric: Tuple[str, ...] = ()
    categorical: Tuple[str, ...] = ()
    cat_bits: int = 20

    @property
    def columns(self) -> Tuple[str, ...]:
        return self.numeric + self.categorical

    @property
    def width(self) -> int:
        return len(self.numeric) + len(self.categorical)


@dataclasses.dataclass(frozen=True)
class Database:
    """A primary table plus named secondary tables (LAST JOIN targets and
    WINDOW UNION streams)."""

    name: str
    primary: TableSchema
    secondary: Tuple[TableSchema, ...] = ()

    def __post_init__(self) -> None:
        names = [self.primary.name] + [t.name for t in self.secondary]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate table names in database: {names}")

    @property
    def tables(self) -> Tuple[TableSchema, ...]:
        return (self.primary,) + self.secondary

    def table(self, name: str) -> TableSchema:
        for t in self.tables:
            if t.name == name:
                return t
        raise KeyError(
            f"table {name!r} not in database {self.name!r} "
            f"(has {[t.name for t in self.tables]})"
        )

    def is_secondary(self, name: str) -> bool:
        return any(t.name == name for t in self.secondary)


class RowCodec:
    """Encode heterogeneous rows into fixed-width f32 vectors (and back)."""

    def __init__(self, schema: TableSchema):
        self.schema = schema
        self._col_index = {c: i for i, c in enumerate(schema.columns)}

    def encode(self, columns: Dict[str, torch.Tensor]) -> torch.Tensor:
        """dict of (N,) canonical tensors -> (N, F) f32 payload."""
        lanes: List[torch.Tensor] = []
        for c in self.schema.numeric:
            lanes.append(columns[c].to(torch.float32))
        for c in self.schema.categorical:
            # zlib.crc32, not hash(): Python string hashing is randomized
            # per process and would break cross-run determinism
            salt = zlib.crc32(c.encode()) & 0x7FFF
            sig = fold_hash(
                [columns[c]], salt=salt, bits=self.schema.cat_bits
            )
            lanes.append(sig.to(torch.float32))
        return torch.stack(lanes, dim=-1)

    def column(self, payload: torch.Tensor, name: str) -> torch.Tensor:
        return payload[..., self._col_index[name]]

    def col_id(self, name: str) -> int:
        return self._col_index[name]


@dataclasses.dataclass
class RingStore:
    """Per-key timestamp-ordered ring buffers."""

    ts: torch.Tensor       # (K, C) int32
    vals: torch.Tensor     # (K, C, F) f32
    cursor: torch.Tensor   # (K,) int32, monotone row count per key

    @property
    def num_keys(self) -> int:
        return self.ts.shape[0]

    @property
    def capacity(self) -> int:
        return self.ts.shape[1]

    @property
    def width(self) -> int:
        return self.vals.shape[2]


def ring_init(
    num_keys: int, capacity: int, width: int, device: torch.device
) -> RingStore:
    return RingStore(
        ts=torch.full(
            (num_keys, capacity), TS_EMPTY, dtype=torch.int32, device=device
        ),
        vals=torch.zeros(
            (num_keys, capacity, width), dtype=torch.float32, device=device
        ),
        cursor=torch.zeros((num_keys,), dtype=torch.int32, device=device),
    )


def ring_ingest(
    store: RingStore,
    key: torch.Tensor,   # (N,) int32; == K marks a pad row
    ts: torch.Tensor,    # (N,) int32, batch sorted by (key, ts)
    vals: torch.Tensor,  # (N, F) f32 payloads
) -> RingStore:
    """Apply a (key, ts)-sorted batch to the rings, in place.

    Each row's slot is ``(cursor[key] + rank) % C`` with ``rank`` its
    position in its key's run.  When a run holds more than C rows, slots
    repeat and the later row wins (the reference scatter's result), so
    only the last C rows of a run are written.  Pad rows (key == K) write
    nothing.
    """
    n = key.shape[0]
    if n == 0:
        return store
    K, cap = store.ts.shape
    dev = key.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = key[1:] != key[:-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), 0).values
    rank = idx - seg_start
    run_id = torch.cumsum(is_start, 0, dtype=torch.int32) - 1
    run_len = torch.bincount(run_id, minlength=1).to(torch.int32)[run_id]
    valid = key < K
    kc = torch.clamp(key, max=K - 1)
    slot = (store.cursor[kc] + rank) % cap
    w = valid & (rank >= run_len - cap)
    store.ts[key[w], slot[w]] = ts[w]
    store.vals[key[w], slot[w]] = vals[w]
    store.cursor.index_add_(
        0, key[valid], torch.ones_like(key[valid])
    )
    return store


def ring_gather(
    store: RingStore, keys: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gather each queried key's ring unrolled oldest->newest.

    Returns (ts (Q, C), vals (Q, C, F), valid (Q, C)).
    """
    cap = store.capacity
    cur = store.cursor[keys]  # (Q,)
    offs = torch.arange(cap, dtype=torch.int32, device=keys.device)[None, :]
    age_rank = cur[:, None] - cap + offs  # absolute row index; <0: never written
    slots = (age_rank % cap).long()
    valid = age_rank >= 0
    ts = torch.gather(store.ts[keys], 1, slots)
    vals = torch.gather(
        store.vals[keys], 1,
        slots[..., None].expand(-1, -1, store.vals.shape[2]),
    )
    return ts, vals, valid
