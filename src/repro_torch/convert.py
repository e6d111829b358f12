"""Carry online-store state between this package and the JAX reference.

The six primary arrays of an online store — ring ts / vals / cursor and
bucket stats / bitmap / ids — as numpy, either single-device ``(K, ...)``
or sharded ``(S, K_local, ...)``.  The tests seed both packages' stores
from the same warm state with these (the part weight conversion plays for
a model), and read states back to compare them bit for bit.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import preagg as pg
from repro_torch.core import storage as st
from repro_torch.core.online import OnlineState

__all__ = ["STATE_ARRAYS", "online_state_from_numpy", "online_state_to_numpy"]

# names and dtypes of the six primary arrays, in kernel argument order
STATE_ARRAYS = (
    ("ring_ts", np.int32),
    ("ring_vals", np.float32),
    ("cursor", np.int32),
    ("bstats", np.float32),
    ("bbitmap", np.int32),
    ("bbucket", np.int32),
)


def online_state_from_numpy(
    arrays: Union[Mapping[str, np.ndarray], Sequence[np.ndarray]],
    device="cuda",
    *,
    bucket_size: int,
) -> OnlineState:
    """An :class:`OnlineState` on ``device`` holding copies of ``arrays``
    (a mapping keyed by :data:`STATE_ARRAYS` names, or the six arrays in
    that order).  ``bucket_size`` is the bucket width the states were
    aggregated with."""
    if isinstance(arrays, Mapping):
        arrays = [arrays[name] for name, _ in STATE_ARRAYS]
    if len(arrays) != len(STATE_ARRAYS):
        raise ValueError(f"need {len(STATE_ARRAYS)} arrays, got {len(arrays)}")
    dev = resolve_device(device)
    t = []
    for (name, dtype), a in zip(STATE_ARRAYS, arrays):
        a = np.asarray(a)
        if a.dtype != dtype:
            raise TypeError(f"{name}: expected {np.dtype(dtype)}, got {a.dtype}")
        t.append(torch.from_numpy(np.array(a, copy=True)).to(dev))
    ring_ts, ring_vals, cursor, bstats, bbitmap, bbucket = t
    return OnlineState(
        ring=st.RingStore(ts=ring_ts, vals=ring_vals, cursor=cursor),
        bagg=pg.BucketAgg(
            stats=bstats, bitmap=bbitmap, bucket=bbucket, size=bucket_size
        ),
    )


def online_state_to_numpy(state: OnlineState) -> Dict[str, np.ndarray]:
    """The six primary arrays of ``state`` as host numpy copies."""
    return {
        name: t.detach().cpu().numpy()
        for (name, _), t in zip(STATE_ARRAYS, state.arrays())
    }
