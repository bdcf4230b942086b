"""The port's in-memory tracer: named spans on the host's ``perf_counter``
clock, counters, and the blocking device reads (host syncs) of the engine.

``SlamEngine`` owns one :class:`Tracer` and makes it the current one for
the length of each of its calls while tracing is on: when the engine was
built with ``trace=True``, or when a ``torch.profiler`` session is active
as the call starts (:func:`profiler_active`). The functions below record
into the current tracer; with none current they cost one lookup and
allocate nothing (:func:`span` returns a shared no-op). Nothing here
emits a profiler annotation: the spans stay on the host, and a reader
places the profiler's device operations in them through the clock offset
(profiler ns = ``perf_counter_ns`` + offset, taken as the profiler starts),
corrected where the profiler's device clock drifts by the ``launch``
spans (``slambench/metrics/_program_spans.py``).

A span record is ``{"name", "parent", "frame", "t0_ns", "t1_ns"}`` (the
index of the enclosing span or -1, the frame being processed or -1 for
``reset`` and ``finalize``) plus, where the site gives them, ``"site"`` (a
``sync`` span's read) and ``"launches"`` (kernel launches made while it was
open). Records are kept in the order spans open, so a parent precedes its
children. A ``launch`` span (``"kernel"``) wraps each launch call of a
``csrc/knn.cu`` kernel.
"""

from __future__ import annotations

import contextvars
import time

import torch

_current: contextvars.ContextVar = contextvars.ContextVar("slam_tracer",
                                                          default=None)


def profiler_active() -> bool:
    """Whether a ``torch.profiler`` (or autograd profiler) session is on."""
    return torch._C._autograd._profiler_enabled()


class _Null:
    """The shared do-nothing context of a site while tracing is off."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL = _Null()


class Tracer:
    """The spans and counters recorded since the last :meth:`clear`."""

    def __init__(self):
        self.spans: list = []       # [name, parent, frame, t0, t1, extra]
        self.counters: dict = {}
        self.frame = -1
        self.armed = False          # was current in a call since clear()
        self._open: list = []       # indices of the spans open now

    def clear(self) -> None:
        self.spans, self.counters, self._open = [], {}, []
        self.frame, self.armed = -1, False

    def bind(self, frame: int) -> "_Bound":
        """Context that makes this tracer current, at ``frame``."""
        return _Bound(self, frame)

    def records(self) -> dict:
        """``{"spans": [...], "counters": {...}}``, plain Python values."""
        spans = []
        for name, parent, frame, t0, t1, extra in self.spans:
            rec = dict(name=name, parent=parent, frame=frame, t0_ns=t0, t1_ns=t1)
            if extra:
                rec.update(extra)
            spans.append(rec)
        return {"spans": spans, "counters": dict(self.counters)}


class _Bound:
    __slots__ = ("tracer", "frame", "token")

    def __init__(self, tracer: Tracer, frame: int):
        self.tracer, self.frame, self.token = tracer, frame, None

    def __enter__(self):
        self.tracer.frame, self.tracer.armed = self.frame, True
        self.token = _current.set(self.tracer)
        return self.tracer

    def __exit__(self, *exc):
        _current.reset(self.token)
        return False


class _Span:
    """One open span; with ``timing`` it also stores its wall seconds, after
    a sync of the ``sync`` device, whether tracing is on or off."""

    __slots__ = ("tracer", "name", "timing", "key", "sync", "kernels",
                 "extra", "idx", "t0", "base")

    def __init__(self, tracer, name, timing=None, key=None, sync=None,
                 kernels=(), extra=None):
        self.tracer, self.name = tracer, name
        self.timing, self.key, self.sync = timing, key or name, sync
        self.kernels, self.extra = kernels, extra

    def __enter__(self):
        tr = self.tracer
        if tr is not None:
            self.idx = len(tr.spans)
            tr.spans.append([self.name, tr._open[-1] if tr._open else -1,
                             tr.frame, 0, 0, self.extra])
            tr._open.append(self.idx)
            self.base = [k.launches for k in self.kernels]
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.timing is not None and self.sync is not None \
                and self.sync.type == "cuda":
            torch.cuda.synchronize(self.sync)
        t1 = time.perf_counter_ns()
        if self.timing is not None:
            self.timing[self.key] = (t1 - self.t0) / 1e9
        tr = self.tracer
        if tr is not None:
            rec = tr.spans[self.idx]
            rec[3], rec[4] = self.t0, t1
            if self.kernels:
                rec[5] = {"launches": {k.name: k.launches - b for k, b in
                                       zip(self.kernels, self.base)}}
            tr._open.pop()
        return False


def span(name: str, timing: dict | None = None, key: str | None = None,
         sync: torch.device | None = None, kernels: tuple = ()):
    """Context of a span ``name`` in the current tracer (the shared no-op
    when there is none and no ``timing``).

    ``timing``: a dict that gets the span's wall seconds under ``key``
    (default ``name``), measured after a device sync on ``sync`` (a
    ``torch.device``; none where the work ends in a host read) with tracing
    on or off. ``kernels``: objects with a ``launches`` count (the
    ``knn_cuda`` kernels); the span records how many each made."""
    tr = _current.get()
    if tr is None and timing is None:
        return NULL
    return _Span(tr, name, timing, key, sync, kernels)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the current tracer's counter ``name``."""
    tr = _current.get()
    if tr is not None:
        tr.counters[name] = tr.counters.get(name, 0) + n


def waiting(site: str):
    """Context of a wait for the device at ``site`` (a copy that syncs the
    stream): a ``sync`` span, counted under ``host_syncs.<site>``."""
    tr = _current.get()
    if tr is None:
        return NULL
    count("host_syncs." + site)
    return _Span(tr, "sync", extra={"site": site})


def launching(kernel: str):
    """Context of the host call that launches ``kernel``: a ``launch`` span
    naming it. The device starts the kernel after the span starts, which
    anchors the profiler's device clock to this one."""
    tr = _current.get()
    if tr is None:
        return NULL
    return _Span(tr, "launch", extra={"kernel": kernel})


def as_list(x: torch.Tensor) -> list:
    return x.cpu().tolist()


def host_read(site: str, x: torch.Tensor, conv=bool):
    """``conv(x)`` (``bool``, ``int``, ``float`` or :func:`as_list`): a
    device value read on the host, which waits for the device. While
    tracing is on, the wait is a ``sync`` span counted under
    ``host_syncs.<site>``."""
    if _current.get() is None:
        return conv(x)
    with waiting(site):
        return conv(x)
