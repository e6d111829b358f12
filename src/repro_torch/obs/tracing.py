"""Nested request-path spans with explicit device fencing.

CUDA work is asynchronous: a PyTorch call on a CUDA tensor returns as soon
as its kernels are queued, so a naive ``perf_counter`` pair around it
measures *enqueue* cost, not compute.  A :class:`Span` therefore carries a
``fence()`` method — ``torch.cuda.synchronize()`` when any fenced value
lives on a CUDA device, a no-op for CPU tensors and host values — so a
span that claims to measure device time provably contains it.  Host-side
stages (queue wait, shard routing, scatter-back) never fence; device
stages always do.

Spans nest via a stack (``tracer.span(...)`` context managers), and every
completed span *also* folds its duration into the ``span_seconds{name=}``
histogram in the metric registry.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import deque
from typing import Any, Deque, Dict, Iterator, List, Optional

import torch

__all__ = ["Span", "Tracer", "SPAN_KINDS", "fence"]

SPAN_KINDS = ("host", "device")


def _cuda_devices(value: Any, out: set) -> None:
    """Collect the CUDA devices of every tensor inside ``value`` (tensors,
    and tuples / lists / dicts / dataclasses of them)."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        for f in dataclasses.fields(value):
            _cuda_devices(getattr(value, f.name), out)


def fence(*values: Any) -> Any:
    """Wait for the device work producing ``values``; returns them unchanged
    (one value, or a tuple of several)."""
    devices: set = set()
    for v in values:
        _cuda_devices(v, devices)
    for d in devices:
        torch.cuda.synchronize(d)
    return values[0] if len(values) == 1 else values


class Span:
    """One timed stage of the request path (possibly with children).

    ``kind`` is ``"host"`` or ``"device"``; a device span should call
    :meth:`fence` on the stage's outputs before it closes, so the recorded
    duration includes device execution rather than just async enqueue.
    """

    __slots__ = ("name", "kind", "t0", "t1", "attrs", "children", "fenced")

    def __init__(self, name: str, kind: str, t0: float,
                 attrs: Optional[Dict[str, Any]] = None):
        if kind not in SPAN_KINDS:
            raise ValueError(f"span kind must be one of {SPAN_KINDS}: {kind!r}")
        self.name = name
        self.kind = kind
        self.t0 = t0
        self.t1: Optional[float] = None
        self.attrs: Dict[str, Any] = dict(attrs or {})
        self.children: List["Span"] = []
        self.fenced = False

    @property
    def duration_s(self) -> float:
        return 0.0 if self.t1 is None else self.t1 - self.t0

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def fence(self, *values: Any) -> Any:
        """Synchronize the CUDA devices holding the stage outputs inside
        this span, so its duration attributes device compute to this stage.
        Returns the fenced value(s) unchanged."""
        out = fence(*values)
        self.fenced = True
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "kind": self.kind,
            "t0_s": self.t0,
            "duration_s": self.duration_s,
            "fenced": self.fenced,
            "attrs": dict(self.attrs),
            "children": [c.to_dict() for c in self.children],
        }

    def tree(self, indent: int = 0) -> str:
        """Human-readable nested rendering."""
        pad = "  " * indent
        mark = "⏚" if self.fenced else "·"
        lines = [
            f"{pad}{self.name} [{self.kind}] {mark} "
            f"{self.duration_s * 1e3:.3f} ms"
            + (f"  {self.attrs}" if self.attrs else "")
        ]
        for c in self.children:
            lines.append(c.tree(indent + 1))
        return "\n".join(lines)

    def find(self, name: str) -> List["Span"]:
        """All descendants (including self) with the given name."""
        out = [self] if self.name == name else []
        for c in self.children:
            out.extend(c.find(name))
        return out


class _NullSpan:
    """No-op span handle for disabled telemetry — same surface as Span."""

    __slots__ = ()
    name = kind = ""
    attrs: Dict[str, Any] = {}
    duration_s = 0.0
    fenced = False

    def set(self, **attrs: Any) -> "_NullSpan":
        return self

    def fence(self, *values: Any) -> Any:
        # still fence: disabled telemetry must not change when results are
        # ready, only whether the stage is recorded
        return fence(*values)


_NULL = _NullSpan()


class Tracer:
    """Stack-based span builder over one clock + metric registry.

    Completed *root* spans are kept in a bounded deque (``capacity``);
    every completed span additionally aggregates into the
    ``span_seconds{name=...}`` histogram so the per-stage breakdown is
    available without tree-walking.
    """

    def __init__(self, clock, registry=None, capacity: int = 256,
                 enabled: bool = True):
        self.clock = clock
        self.registry = registry
        self.capacity = capacity
        self.enabled = enabled
        self._stack: List[Span] = []
        self._roots: Deque[Span] = deque(maxlen=capacity)

    @contextlib.contextmanager
    def span(self, name: str, kind: str = "host",
             **attrs: Any) -> Iterator[Span]:
        if not self.enabled:
            yield _NULL
            return
        s = Span(name, kind, self.clock.now(), attrs)
        self._stack.append(s)
        try:
            yield s
        finally:
            s.t1 = self.clock.now()
            popped = self._stack.pop()
            assert popped is s, "span stack corrupted"
            if self._stack:
                self._stack[-1].children.append(s)
            else:
                self._roots.append(s)
            if self.registry is not None:
                self.registry.histogram(
                    "span_seconds",
                    help="wall time per request-path stage",
                    unit="s",
                    labels=("name", "kind"),
                ).observe(s.duration_s, name=s.name, kind=s.kind)

    def roots(self) -> List[Span]:
        """Completed top-level spans, oldest first (bounded window)."""
        return list(self._roots)

    def last_root(self, name: Optional[str] = None) -> Optional[Span]:
        for s in reversed(self._roots):
            if name is None or s.name == name:
                return s
        return None

    def clear(self) -> None:
        self._roots.clear()
