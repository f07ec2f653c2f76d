"""Spans inside the port, on the profiler's clock; off by default.

A span is a named stretch of the program: its start and end on the host
(``time.time_ns``, the clock ``torch.profiler``'s events carry).  Opened
with ``device=True`` in a process that has initialised CUDA it also
records a pair of CUDA events on the current stream; their milliseconds
are read only by :func:`collect` (or :meth:`Span.ms` after :func:`settle`),
after the stretch being measured, so the hot path never waits on the card.
While a profiler is active a span over a block also opens
``torch.profiler.record_function`` under its name, so that the profiler's
trace holds it as a user annotation and the card's idle gaps can be put
down to the span open at the time; the ranges nest as the blocks do, and
the trace's nesting is the spans' (on the card autograd runs the backward
on a thread of its own, and its spans still fall inside the caller's
``train/backward``).

Tracing is off until :func:`enable`.  Off, a span site costs one check
of a module flag: no event is made, no range is opened, nothing is kept.
:func:`collect` hands out the closed spans and clears them; nothing is
written anywhere.

The spans the port opens, and their nesting:

- ``serve/run`` (``ServeEngine.run``) over ``serve/queue`` (one a
  request: from ``run``'s entry to the request's slot admission),
  ``serve/prefill`` (a refill's padding, prefill and splice; device) over
  ``serve/splice`` (device), ``serve/decode`` (the call of
  ``Model.decode``; device) and ``serve/sync`` (the greedy tokens read
  back to the host);
- ``train/step`` (device) over ``train/forward`` and ``train/backward``
  (device; the latter over ``train/remat``, a checkpointed layer's
  recompute, ``attention/backward`` and ``ssd/backward``, the kernels'
  recompute backwards), ``train/reduce`` (the mesh step's gradient
  reduction) and ``train/optimizer`` (AdamW), all on the device;
- ``collective/<label>`` around each collective (on the device when its
  tensor is on the card; no profiler range, as the process group opens
  its own), which ``record_collectives(timed=True)`` also takes with
  tracing off.
"""
from __future__ import annotations

import time
from typing import Iterable, List, Optional

import torch

__all__ = ["Span", "enable", "disable", "on", "collect", "settle", "span",
           "start", "stop"]

_ON = False
_DONE: List["Span"] = []      # closed spans, in the order they closed


class Span:
    """One span: ``name``, ``start_ns`` and ``end_ns`` on the host's
    ``time.time_ns`` clock, and, once settled, ``device_ms`` (None without
    CUDA events)."""

    __slots__ = ("name", "start_ns", "end_ns", "device_ms", "_events")

    def __init__(self, name: str, device: bool = False):
        self.name = name
        self.end_ns: Optional[int] = None
        self.device_ms: Optional[float] = None
        self._events = None
        if device and torch.cuda.is_initialized():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._events = [ev]
        self.start_ns = time.time_ns()

    def finish(self) -> None:
        self.end_ns = time.time_ns()
        if self._events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._events.append(ev)

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def ms(self) -> float:
        """The span's length: on the device where it has events (settled
        first, :func:`settle`), else on the host."""
        return self.host_ms if self.device_ms is None else self.device_ms

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, host_ms={self.host_ms:.3f}, "
                f"device_ms={self.device_ms})")


def settle(spans: Iterable[Span]) -> None:
    """Read the device milliseconds of ``spans``' CUDA events (one
    synchronise, where any span has them) and release the events."""
    timed = [s for s in spans if s._events is not None]
    if not timed:
        return
    torch.cuda.synchronize()
    for s in timed:
        a, b = s._events
        s.device_ms, s._events = a.elapsed_time(b), None


class _Off:
    """The span of a site while tracing is off: nothing at all."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Block:
    """A span over a block, with a profiler range while a profiler is
    active (where ``annotate``)."""

    __slots__ = ("name", "device", "annotate", "span", "_range")

    def __init__(self, name, device, annotate):
        self.name, self.device, self.annotate = name, device, annotate

    def __enter__(self) -> Span:
        self._range = None
        if self.annotate and torch._C._autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
        # the host stamps sit right outside the range's own
        self.span = Span(self.name, self.device)
        if self._range is not None:
            self._range.__enter__()
        return self.span

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
        self.span.finish()
        if _ON:
            _DONE.append(self.span)
        return False


def span(name: str, *, device: bool = False, always: bool = False,
         annotate: bool = True):
    """``with span(name):`` a span over the block, yielding its
    :class:`Span`; kept for :func:`collect` while tracing is on.  With
    ``always`` it is taken (and yielded) with tracing off as well, for a
    caller that keeps it itself; otherwise, off, the block runs alone and
    the ``with`` yields None.  ``annotate=False`` opens no profiler
    range."""
    if not (_ON or always):
        return _OFF
    return _Block(name, device, annotate)


def start(name: str) -> Optional[Span]:
    """A span of host time that does not cover one block (a request's
    wait in a queue); None while tracing is off.  :func:`stop` ends it."""
    return Span(name) if _ON else None


def stop(s: Optional[Span]) -> None:
    """End a span of :func:`start` (None: nothing)."""
    if s is not None:
        s.finish()
        if _ON:
            _DONE.append(s)


def on() -> bool:
    """Whether tracing is on."""
    return _ON


def enable() -> None:
    """Turn tracing on, with no span kept yet."""
    global _ON
    _DONE.clear()
    _ON = True


def disable() -> None:
    """Turn tracing off; the spans kept so far wait for :func:`collect`."""
    global _ON
    _ON = False


def collect() -> List[Span]:
    """Every span closed since tracing was turned on or last collected, in
    the order they closed, settled (:func:`settle`); the tracer keeps none
    of them."""
    out = list(_DONE)
    _DONE.clear()
    settle(out)
    return out
