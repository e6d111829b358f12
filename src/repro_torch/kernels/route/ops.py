"""Dispatchers for the route kernel (B2).

* ``route_keys(key, valid, perm, num_shards=S)`` -> (local, shard, rank,
  counts, valid counts): the routing of the device-routed request path
  (:meth:`repro_torch.core.shard.ShardedOnlineStore.query`) in one launch —
  each key walked through the Feistel permutation ``perm``
  (:class:`repro_torch.core.hashing.KeyPermutation`), then ranked within
  its shard.
* ``route_rank(shard, num_shards=S)`` -> (rank within shard, per-shard
  counts): the rank alone, from shard ids.

CUDA tensors launch the hand-written kernel (``kernels/csrc/route_rank.cu``,
one source, one instantiation each); CPU tensors run the plain versions
(:mod:`.ref`).  Integer results, identical either way.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import count_launch, note_dispatch, use_cuda_kernel
from repro_torch.kernels.route.ref import route_keys_ref, route_rank_ref

__all__ = [
    "route_keys", "route_rank", "launch_route", "launch_empty",
    "MAX_SHARDS", "TILE",
]

# shared memory holds two buffers of (shard, warp) counts; 64 shards x 8
# warps x 2 buffers is 4 KB
MAX_SHARDS = 64
# rows a block handles at a time (the kernel's THREADS)
TILE = 256

_fns: Dict[str, object] = {}
# (device index, stream) -> the grid barrier's two words, zeroed once; every
# launch leaves them zero, and launches on one stream never overlap
_SYNC: Dict[Tuple[int, int], torch.Tensor] = {}


def _fn(name: str, argtypes):
    fn = _fns.get(name)
    if fn is None:
        from repro_torch.kernels.build import library

        fn = getattr(library("route_rank"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _sync_words(dev: torch.device, stream: int) -> torch.Tensor:
    sync = _SYNC.get((dev.index, stream))
    if sync is None:
        sync = torch.zeros(2, dtype=torch.int32, device=dev)
        _SYNC[(dev.index, stream)] = sync
    return sync


def launch_route(
    inp: torch.Tensor,        # (N,) int32 keys (perm given) or shard ids
    rank: torch.Tensor,       # (N,) int32
    counts: torch.Tensor,     # (S,) int32
    scratch: torch.Tensor,    # (2 * S * ceil(N / TILE),) int32
    perm=None,
    valid: torch.Tensor = None,         # (N,) bool, keys only
    local: torch.Tensor = None,         # (N,) int32, keys only
    shard: torch.Tensor = None,         # (N,) int32, keys only
    valid_counts: torch.Tensor = None,  # (S,) int32, keys only
) -> None:
    """Launch the CUDA kernel on the current stream (one launch, counted);
    every output is written whole.  With ``perm`` the keys are walked and
    ``local``, ``shard`` and ``valid_counts`` are written too.  Raises if
    the launch fails."""
    fn = _fn("route_launch", [ctypes.c_int] + [ctypes.c_void_p] * 9
             + [ctypes.c_int] * 6 + [ctypes.c_uint, ctypes.c_int,
                                     ctypes.c_void_p])
    dev = inp.device
    stream = _stream(dev)
    keys = perm is not None

    def ptr(t):
        return t.data_ptr() if t is not None else None

    f = (perm.half, perm.mask, perm.upper, perm.rounds,
         perm.salt & 0xFFFFFFFF) if keys else (0, 0, 0, 0, 0)
    err = fn(
        int(keys), inp.data_ptr(), ptr(valid), ptr(local), ptr(shard),
        rank.data_ptr(), counts.data_ptr(), ptr(valid_counts),
        scratch.data_ptr(), _sync_words(dev, stream).data_ptr(),
        inp.shape[0], counts.shape[0], *f, dev.index, stream,
    )
    if inp.shape[0] > 0:
        count_launch("route_rank", variant="keys" if keys else "shards")
    if err != 0:
        raise RuntimeError(f"route kernel launch failed: CUDA error {err}")


def launch_empty(dev: torch.device) -> None:
    """Launch an empty kernel through the same ctypes path (not counted):
    the launch floor the route kernel is read against."""
    fn = _fn("route_empty_launch", [ctypes.c_int, ctypes.c_void_p])
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    err = fn(dev.index, _stream(dev))
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")


def _check(name: str, t: torch.Tensor, num_shards: int) -> None:
    if t.dtype != torch.int32 or t.dim() != 1:
        raise TypeError(f"{name}: expects 1-D int32, got {t.dtype} "
                        f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    if not 1 <= num_shards <= MAX_SHARDS:
        raise ValueError(f"{name}: num_shards must be in [1, {MAX_SHARDS}], "
                         f"got {num_shards}")


def _outputs(n: int, S: int, dev: torch.device, k: int):
    """One allocation split into k (N,) outputs, two (S,) ones and the
    scratch."""
    sizes = [n] * k + [S, S, 2 * S * -(-n // TILE)]
    parts = torch.empty(sum(sizes), dtype=torch.int32, device=dev).split(sizes)
    return parts[:k], parts[k], parts[k + 1], parts[k + 2]


def route_keys(
    key: torch.Tensor,    # (N,) int32 keys in [0, perm.upper)
    valid: torch.Tensor,  # (N,) bool
    perm,                 # repro_torch.core.hashing.KeyPermutation
    *,
    num_shards: int,
) -> Tuple[torch.Tensor, ...]:
    """(local, shard, rank, counts, valid_counts), int32: ``local = perm(key)
    // S``, ``shard = perm(key) % S``, each row's rank within its shard in
    batch order, the rows per shard and the rows per shard that ``valid``
    keeps.  A key outside [0, perm.upper) has local = shard = -1, rank 0
    and counts nowhere."""
    if not use_cuda_kernel("route_rank", key, valid):
        note_dispatch("route_rank", "ref")
        return route_keys_ref(key, valid, perm, num_shards)
    note_dispatch("route_rank", "cuda")
    _check("route_keys", key, num_shards)
    if valid.dtype != torch.bool or valid.shape != key.shape:
        raise TypeError(f"route_keys: valid must be bool of shape "
                        f"{tuple(key.shape)}, got {valid.dtype} "
                        f"{tuple(valid.shape)}")
    if perm.size > 0x7FFFFFFF or perm.upper > perm.size:
        raise ValueError(f"route_keys: needs an int32 permutation domain, "
                         f"got upper {perm.upper}, size {perm.size}")
    n = key.shape[0]
    (local, shard, rank), counts, vcounts, scratch = _outputs(
        n, num_shards, key.device, 3)
    if n == 0:
        counts.zero_()
        vcounts.zero_()
        return local, shard, rank, counts, vcounts
    launch_route(key, rank, counts, scratch, perm=perm,
                 valid=valid.contiguous(), local=local, shard=shard,
                 valid_counts=vcounts)
    return local, shard, rank, counts, vcounts


def route_rank(
    shard: torch.Tensor,  # (N,) int32 shard ids in [0, num_shards)
    *,
    num_shards: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rank (N,) int32, counts (S,) int32): rank of each row within its
    shard in batch order, and rows per shard; ids outside [0, S) get rank
    0 and count nowhere."""
    if not use_cuda_kernel("route_rank", shard):
        note_dispatch("route_rank", "ref")
        return route_rank_ref(shard, num_shards)
    note_dispatch("route_rank", "cuda")
    _check("route_rank", shard, num_shards)
    n = shard.shape[0]
    (rank,), counts, _, scratch = _outputs(n, num_shards, shard.device, 1)
    if n == 0:
        counts.zero_()
        return rank, counts
    launch_route(shard, rank, counts, scratch)
    return rank, counts
