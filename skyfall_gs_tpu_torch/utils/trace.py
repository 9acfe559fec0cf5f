"""Spans and counters inside the program, switched by ``torch.profiler``.

Three calls:
  * ``span(name, arg=None)``: a context manager, or a decorator, around one
    phase of the work;
  * ``count(name, value)``: adds a Python number or a 0-d tensor to a
    counter, without reading the device;
  * ``report()``: the spans and counters of the last profiled window.

The profiler is the only switch.  While no profiler records, a span or a
count checks ``torch._C._autograd._profiler_enabled()`` and does nothing
more, so untraced runs pay a few hundred nanoseconds per span (a span
object is reusable: hot paths keep one at module level and skip building
it).  While one
records, a span enters ``torch.profiler.record_function(name)`` (so it lands
in the chrome trace, on the device trace's clock, beside the kernels it
launched) and keeps in memory its parent, its host duration and, once CUDA
is in use, a pair of CUDA events recorded on the current stream: their
elapsed time is the span's share of the device timeline (its kernels and
any wait for the host inside it).  Without CUDA device time is host time.

A counter keeps device values in a small device buffer filled by
device-to-device copies (a copy launches no kernel) and sums it in
``report()``.  The registry covers one profiled window: the first span or
count that runs while a profiler records, after any ran while none did,
starts it afresh.  Event pairs are resolved in batches as they complete.
"""

from __future__ import annotations

import functools
import threading
import time

import torch

_enabled = torch._C._autograd._profiler_enabled
_BATCH = 1024


class _Registry:
    """The spans and counters of one profiled window."""

    def __init__(self):
        self.stale = False      # a span or count ran while no profiler recorded
        self.open = 0           # spans entered while a profiler recorded, not yet left
        self.lock = threading.Lock()
        self.local = threading.local()
        self.free = []          # CUDA events to reuse
        self.reset()

    def reset(self) -> None:
        self.stale = False
        self.spans = {}         # name -> [count, host ns, self host ns, device s, parent]
        self.pending = []       # (name, start event, end event) not yet resolved
        self.counters = {}      # name -> _Counter

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def event(self):
        e = self.free.pop() if self.free else torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def resolve(self, block: bool) -> None:
        """Adds the device time of the pending pairs whose end has run, of
        all of them with ``block``."""
        done = 0
        for name, e0, e1 in self.pending:
            if block:
                e1.synchronize()
            elif not e1.query():
                break
            self.spans[name][3] += e0.elapsed_time(e1) * 1e-3
            self.free += (e0, e1)
            done += 1
        del self.pending[:done]


_R = _Registry()


class _Counter:
    def __init__(self):
        self.host = 0
        self.buf, self.n, self.acc = None, 0, None

    def add(self, value) -> None:
        if not isinstance(value, torch.Tensor):
            self.host += value
            return
        value = value.detach()
        buf = self.buf
        if (buf is None or self.n == _BATCH or buf.device != value.device
                or buf.dtype != value.dtype):
            self.fold()
            buf = self.buf = torch.empty(_BATCH, dtype=value.dtype, device=value.device)
        buf[self.n].copy_(value)
        self.n += 1

    def fold(self) -> None:
        if self.n:
            part = self.buf[:self.n].sum()
            self.acc = part if self.acc is None else self.acc + part.to(self.acc)
        self.buf, self.n = None, 0

    def total(self):
        self.fold()
        return self.host + (0 if self.acc is None else self.acc.item())


class span:
    """One phase of the work, named ``name`` (``arg``: a value shown beside
    it in the chrome trace).  Reusable, nestable; ``@span(name)`` wraps a
    function."""

    __slots__ = ("name", "arg")

    def __init__(self, name: str, arg=None):
        self.name, self.arg = name, arg

    def __enter__(self):
        if not _enabled():
            _R.stale = True
            return self
        if _R.stale:
            _R.reset()
        rf = torch.autograd.profiler.record_function(
            self.name, None if self.arg is None else str(self.arg))
        rf.__enter__()
        ev = _R.event() if torch.cuda.is_initialized() else None
        _R.stack().append([self, rf, ev, time.perf_counter_ns(), 0])
        with _R.lock:
            _R.open += 1
        return self

    def __exit__(self, exc_type, exc, tb):
        if not _R.open:
            return False
        stack = _R.stack()
        if not stack or stack[-1][0] is not self:
            return False            # entered while no profiler recorded
        _, rf, ev0, t0, child = stack.pop()
        with _R.lock:
            _R.open -= 1
        ev1 = _R.event() if ev0 is not None else None
        dur = time.perf_counter_ns() - t0
        rf.__exit__(None, None, None)
        rec = _R.spans.get(self.name)
        if rec is None:
            rec = _R.spans[self.name] = [0, 0, 0, 0.0, stack[-1][0].name if stack else None]
        rec[0] += 1
        rec[1] += dur
        rec[2] += dur - child
        if stack:
            stack[-1][4] += dur
        if ev0 is None:
            rec[3] += dur * 1e-9
        else:
            _R.pending.append((self.name, ev0, ev1))
            if len(_R.pending) >= _BATCH:
                _R.resolve(block=len(_R.pending) >= 4 * _BATCH)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not _enabled():
                _R.stale = True
                return fn(*args, **kwargs)
            with self:
                return fn(*args, **kwargs)

        return wrapped


def count(name: str, value) -> None:
    """Adds ``value`` (a Python number or a 0-d tensor, read at ``report``)
    to counter ``name`` while a profiler records."""
    if not _enabled():
        _R.stale = True
        return
    if _R.stale:
        _R.reset()
    c = _R.counters.get(name)
    if c is None:
        c = _R.counters[name] = _Counter()
    c.add(value)


def report() -> dict:
    """The last profiled window: ``{"spans": {name: {"count", "host_s",
    "self_host_s", "device_s", "parent"}}, "counters": {name: total}}``.
    Synchronizes the device once; spans still open are left out."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    _R.resolve(block=True)
    spans = {name: {"count": c, "host_s": h * 1e-9, "self_host_s": s * 1e-9,
                    "device_s": d, "parent": p}
             for name, (c, h, s, d, p) in _R.spans.items()}
    return {"spans": spans, "counters": {k: c.total() for k, c in _R.counters.items()}}
