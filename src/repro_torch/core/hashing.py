"""Integer mix hashing on int32 tensors, plus the numpy host mirror.

The same functions as the reference package's ``repro.core.hashing``, bit
for bit: a murmur3-finalizer ``mix32`` over int32 lanes (wrap-around
multiply, arithmetic ``>>`` where the reference shifts unmasked), a
two-round ``mix64`` folded to ``bits`` bits, and ``fold_hash`` over
several columns.  ``mix32_np`` is the numpy mirror the host-side routing
uses.

:class:`KeyPermutation` is the Feistel bijection the sharded plane routes
with (``shard = perm(key) % S``).  ``__call__`` / ``inverse`` run on the
host in numpy; :meth:`KeyPermutation.device_call` runs on the tensor's
device.  The reference walks out-of-domain ids with a device-side
``while_loop``; eager PyTorch cannot loop on the device without asking
the host every pass, so ``device_call`` runs a fixed number of walk passes
(enough that a batch is rarely left with an out-of-domain id) and returns
a device-side "still walking" flag.  The caller reads that flag in the
same host read as its other per-batch flags and calls
:meth:`KeyPermutation.finish_walk` only when it is set.  On the card the
request path does not use it: the route kernel
(:func:`repro_torch.kernels.route.ops.route_keys`) walks each key to the
end in one launch; ``device_call`` is the CPU path and the kernel's plain
version.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

__all__ = ["mix32", "mix64", "fold_hash", "mix32_np", "KeyPermutation"]

_M1 = -2048144789   # 0x85ebca6b as int32
_M2 = -1028477387   # 0xc2b2ae35 as int32


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """float32 bit patterns reinterpret (so 1.0 and 1 hash differently);
    every other numeric type converts to int32."""
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    return x.to(torch.int32)


def mix32(x: torch.Tensor, salt: int = 0) -> torch.Tensor:
    """murmur3-finalizer style avalanche mix over int32 lanes."""
    h = _as_i32(x) ^ (salt & 0x7FFFFFFF)
    h = h ^ (h >> 16)
    h = h * _M1
    h = h ^ ((h >> 13) & 0x0007FFFF)
    h = h * _M2
    h = h ^ ((h >> 16) & 0x0000FFFF)
    return h


def mix64(x: torch.Tensor, salt: int = 0, bits: int = 32) -> torch.Tensor:
    """Two-round 32-bit mix folded to ``bits`` bits, result in [0, 2**bits)
    (``abs`` wraps at INT32_MIN exactly as the reference's does)."""
    h1 = mix32(x, salt=salt)
    h2 = mix32(h1 ^ 0x5BD1E995, salt=salt ^ 0x27D4EB2F)
    h = h1 ^ (h2 * 5 + 0x38495AB5)
    if bits >= 31:
        return torch.abs(h) & 0x7FFFFFFF
    return torch.abs(h) % (2 ** bits)


def fold_hash(parts, salt: int = 0, bits: int = 20) -> torch.Tensor:
    """Order-sensitive fold of several tensors into one hashed id per row."""
    acc = None
    for i, p in enumerate(parts):
        h = mix64(p, salt=salt + 0x9E37 * (i + 1), bits=32)
        acc = h if acc is None else mix64(acc * 31 + h, salt=salt, bits=32)
    assert acc is not None
    return (acc % (2 ** bits)).to(torch.int32)


# ---------------------------------------------------------------------------
# Host-side mirror (numpy) — ingest routing runs on the host
# ---------------------------------------------------------------------------


def _np_i32(v: np.ndarray) -> np.ndarray:
    """Wrap int64 intermediates to signed 32-bit (int32 overflow semantics)."""
    return ((v + 2**31) % 2**32) - 2**31


def mix32_np(x, salt: int = 0) -> np.ndarray:
    """Bit-exact numpy mirror of :func:`mix32` for int inputs, computed in
    int64 with explicit 32-bit wrapping."""
    h = _np_i32(np.asarray(x, np.int64) ^ (salt & 0x7FFFFFFF))
    h = _np_i32(h ^ (h >> 16))
    h = _np_i32(h * _M1)
    h = _np_i32(h ^ ((h >> 13) & 0x0007FFFF))
    h = _np_i32(h * _M2)
    h = _np_i32(h ^ ((h >> 16) & 0x0000FFFF))
    return h


class KeyPermutation:
    """Deterministic bijection on ``[0, upper)`` — Feistel rounds of the
    module's mixer, with cycle-walking down to the exact domain.

    ``shard = perm(key) % S`` spreads strided key patterns across shards
    while ``local = perm(key) // S`` stays dense and collision-free per
    shard because the map is a bijection.
    """

    def __init__(self, upper: int, rounds: int = 4, salt: int = 0):
        if upper < 1:
            raise ValueError(f"permutation domain must be >= 1, got {upper}")
        self.upper = int(upper)
        bits = max(2, (self.upper - 1).bit_length())
        bits += bits & 1  # even split -> balanced Feistel halves
        self.half = bits // 2
        self.mask = (1 << self.half) - 1
        self.size = 1 << bits
        self.rounds = int(rounds)
        self.salt = int(salt)
        # fixed device walk passes: an id is still outside the domain after
        # p passes with probability (1 - upper/size)^p; 20 bits of margin
        # leaves a 4096-row batch walking further about once in 256 batches
        miss = 1.0 - self.upper / self.size
        self.device_passes = (
            1 if miss <= 0.0 else max(1, math.ceil(20 / -math.log2(miss)))
        )

    def _once(self, x: np.ndarray) -> np.ndarray:
        left = x >> self.half
        right = x & self.mask
        for r in range(self.rounds):
            f = mix32_np(right, salt=self.salt + 0x9E37 * (r + 1)) & self.mask
            left, right = right, left ^ f
        return (left << self.half) | right

    def _once_inv(self, x: np.ndarray) -> np.ndarray:
        """Inverse of one Feistel pass: the rounds run backwards."""
        left = x >> self.half
        right = x & self.mask
        for r in reversed(range(self.rounds)):
            f = mix32_np(left, salt=self.salt + 0x9E37 * (r + 1)) & self.mask
            left, right = right ^ f, left
        return (left << self.half) | right

    def __call__(self, key) -> np.ndarray:
        """Vectorized permuted ids; walks cycles until back in [0, upper)."""
        x = np.atleast_1d(np.asarray(key)).astype(np.int64)
        out = self._once(x)
        bad = out >= self.upper
        while bad.any():
            out[bad] = self._once(out[bad])
            bad = out >= self.upper
        return out.reshape(np.shape(key))

    def inverse(self, key) -> np.ndarray:
        """Exact inverse of :meth:`__call__` on [0, upper)."""
        x = np.atleast_1d(np.asarray(key)).astype(np.int64)
        if x.size and (x.min() < 0 or x.max() >= self.upper):
            raise ValueError(
                f"inverse domain is [0, {self.upper}): "
                f"got [{x.min()}, {x.max()}]"
            )
        out = self._once_inv(x)
        bad = out >= self.upper
        while bad.any():
            out[bad] = self._once_inv(out[bad])
            bad = out >= self.upper
        return out.reshape(np.shape(key))

    # -- device mirror (the request path) ------------------------------------

    def _once_device(self, x: torch.Tensor) -> torch.Tensor:
        """Tensor mirror of :meth:`_once`: every Feistel half stays below
        ``2**half``, where mix32 and mix32_np agree bit for bit."""
        left = x >> self.half
        right = x & self.mask
        for r in range(self.rounds):
            f = mix32(right, salt=self.salt + 0x9E37 * (r + 1)) & self.mask
            left, right = right, left ^ f
        return (left << self.half) | right

    def _walk(self, out: torch.Tensor, passes: int) -> torch.Tensor:
        for _ in range(passes):
            out = torch.where(out >= self.upper, self._once_device(out), out)
        return out

    def device_call(
        self, key: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(permuted int32 ids, still-walking flag), both on ``key``'s
        device, with no host synchronization.

        The ids equal :meth:`__call__` wherever the 0-dim bool flag is
        False; when it is True some ids are still outside the domain and
        :meth:`finish_walk` completes them.
        """
        if self.size > 0x7FFFFFFF:  # pragma: no cover - >2^31 key domains
            raise ValueError(
                f"device permutation needs an int32 domain; size "
                f"{self.size} overflows (route on host instead)"
            )
        out = self._walk(
            self._once_device(key.to(torch.int32)), self.device_passes - 1
        )
        return out, (out >= self.upper).any()

    def finish_walk(self, out: torch.Tensor) -> torch.Tensor:
        """Walk the remaining out-of-domain ids of a :meth:`device_call`
        result home (host-checked loop; the flagged batch only)."""
        while bool((out >= self.upper).any()):
            out = self._walk(out, self.device_passes)
        return out
