"""Carry state and weights between this package and the JAX reference.

* Online-store state: the six primary arrays of an online store — ring
  ts / vals / cursor and bucket stats / bitmap / ids — as numpy, either
  single-device ``(K, ...)`` or sharded ``(S, K_local, ...)``.  The tests
  seed both packages' stores from the same warm state with these, and read
  states back to compare them bit for bit.
* Model weights: :func:`decoder_from_numpy` builds a
  :class:`~repro_torch.models.transformer.DecoderLM`, and
  :func:`rwkv6_from_numpy` a :class:`~repro_torch.models.rwkv6.RWKV6LM`,
  from the reference model's parameter tree as numpy arrays.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import preagg as pg
from repro_torch.core import storage as st
from repro_torch.core.online import OnlineState

__all__ = [
    "STATE_ARRAYS",
    "online_state_from_numpy",
    "online_state_to_numpy",
    "decoder_from_numpy",
    "rwkv6_from_numpy",
    "kv_cache_from_numpy",
]

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


def _flatten(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    for name, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", v


def _load_numpy(model, params: Mapping, n_layers: int, layer_prefix: str,
                who: str):
    """Copy the reference's parameter tree (numpy leaves) into ``model``:
    leaves under ``layers.*`` are stacked on a leading layer axis and go to
    ``<layer_prefix>.<i>.*``, the others by their own name.  Every
    parameter must be given, each with its parameter's shape; values pass
    through float32, so a bfloat16 tree arrives bit for bit in bfloat16
    parameters."""
    own = dict(model.named_parameters())
    unset = set(own)

    def put(name: str, a) -> None:
        if name not in own:
            raise KeyError(f"{who}: no parameter {name!r}")
        p = own[name]
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(
                f"{who}: {name} has shape {tuple(a.shape)}, the model's is "
                f"{tuple(p.shape)}"
            )
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        with torch.no_grad():
            p.copy_(t.to(device=p.device, dtype=p.dtype))
        unset.discard(name)

    for name, a in _flatten(params):
        a = np.asarray(a)
        if name.startswith("layers."):
            if a.shape[0] != n_layers:
                raise ValueError(
                    f"{who}: {name} stacks {a.shape[0]} layers, the config "
                    f"has {n_layers}"
                )
            for i in range(n_layers):
                put(f"{layer_prefix}.{i}.{name[len('layers.'):]}", a[i])
        else:
            put(name, a)
    if unset:
        raise KeyError(f"{who}: parameters not given: {sorted(unset)}")
    return model


def decoder_from_numpy(cfg, params: Mapping, device="cuda"):
    """A :class:`~repro_torch.models.transformer.DecoderLM` of ``cfg`` on
    ``device`` holding the reference model's weights.

    ``params`` is the reference's parameter tree with numpy leaves
    (``jax.tree.map(np.asarray, params)``): ``embed.table`` (and
    ``embed.head`` when untied), the per-layer parameters stacked on a
    leading layer axis under ``layers.*``, and ``ln_out.scale``.
    """
    from repro_torch.models.transformer import DecoderLM

    return _load_numpy(DecoderLM(cfg, device=device), params, cfg.n_layers,
                       "blocks", "decoder_from_numpy")


def rwkv6_from_numpy(cfg, params: Mapping, device="cuda"):
    """A :class:`~repro_torch.models.rwkv6.RWKV6LM` of ``cfg`` on
    ``device`` holding the reference model's weights: ``embed.table``,
    ``layers.{ln_tm,tm,ln_cm,cm}.*`` stacked on a leading layer axis, and
    ``ln_out.scale``, with numpy leaves."""
    from repro_torch.models.rwkv6 import RWKV6LM

    return _load_numpy(RWKV6LM(cfg, device=device), params, cfg.n_layers,
                       "layers", "rwkv6_from_numpy")


def kv_cache_from_numpy(cache_arrays, device="cuda"):
    """The port's :class:`~repro_torch.models.kvcache.FullKV`, or
    :class:`~repro_torch.models.kvcache.SlidingKV` when ``k_pos`` is
    given, on ``device``, holding copies of the reference's cache.

    ``cache_arrays`` maps ``k``, ``v``, ``pos`` (and ``k_pos`` for the
    ring) to arrays, or is the reference's cache object itself (read by
    those attribute names through ``numpy.asarray``).  ``k`` and ``v`` keep
    their dtype (a numpy ``bfloat16`` arrives bit for bit in
    ``torch.bfloat16``); positions are int32."""
    from repro_torch.models import kvcache as kvc

    names = ("k", "v", "pos", "k_pos")
    if not isinstance(cache_arrays, Mapping):
        cache_arrays = {n: getattr(cache_arrays, n) for n in names
                        if hasattr(cache_arrays, n)}
    dev = resolve_device(device)

    def kv(a) -> torch.Tensor:
        a = np.asarray(a)
        dtype = torch.bfloat16 if a.dtype.name == "bfloat16" else None
        t = torch.from_numpy(np.array(a, dtype=np.float32 if dtype else a.dtype))
        return t.to(device=dev, dtype=dtype)

    def positions(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.int32)).to(dev)

    k, v = kv(cache_arrays["k"]), kv(cache_arrays["v"])
    pos = positions(cache_arrays["pos"])
    if "k_pos" in cache_arrays:
        return kvc.SlidingKV(k=k, v=v, k_pos=positions(cache_arrays["k_pos"]),
                             pos=pos)
    return kvc.FullKV(k=k, v=v, pos=pos)
