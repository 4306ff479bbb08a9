"""The port's spans and counters, and a ``torch.profiler`` trace that writes
them out (the tracing of wire_tpu/train/profiling.py, redone for the port).

Spans.  ``span(name)`` is a context manager that records ``name``, an
``id``, its ``parent`` (the span open around it in this thread; in a
thread with none open, such as autograd's device thread running a
backward, the innermost one the main thread has open), its host start and
end on ``time.perf_counter()`` (``t0``, ``t1``, seconds) and, where it has
one, ``device_ms``.  The spans of one fit descend from its
``trainer.fit`` span.  The newest ``STORE_SPANS`` closed spans are kept;
``spans()`` reads them and ``clear()`` empties the store.  There are two
kinds, told apart by the name:

- fit-level spans (every name outside ``HOT``: ``apps.inputs``,
  ``trainer.fit``, ``trainer.setup``, ``build.compile``, ``build.load``)
  run a few times a fit and are always recorded, on the host clock only;
- hot spans (``trainer.epoch``, ``trainer.adam``, ``trainer.tracking``,
  ``wrappers.*``, ``kernels.*``) run every epoch or step and are recorded
  only while a ``torch.profiler`` records.  Off, one is a check of the
  profiler's state and a shared no-op context.  On, it opens a host range
  in the profile (``_RecordFunctionFast``: not a user annotation, so the
  profiler projects nothing of it onto the device timeline) and records a
  CUDA event at its start and end on the current stream when CUDA is up.
  The events are resolved when ``spans()`` is read, which waits for them:
  ``device_ms`` is the stream time from one to the other, the span's own
  device work plus any time the stream waited for the host inside it.  A
  hot span still open when the profiler stops is dropped.

Counters.  ``count(name, n)`` adds to one registry, ``counters()`` reads
it: ``launches.<module>.<direction>`` (each ``ops`` wrapper's kernel
launches, ``launches(module)`` the module's as {direction: count}) and
``build.compiled.<library>`` (the libraries nvcc built in this process).
Counters are always on and never reset; a reader takes differences.

``trace(log_dir)`` profiles a block into a TensorBoard trace and writes
``spans.json`` (the store and the counters) beside it.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import importlib
import itertools
import json
import os
import threading
import time

import torch

# the newest closed spans kept (a profiled 2,000-epoch fit records about
# 10,000: five hot spans an epoch)
STORE_SPANS = 65536
# the names (by prefix) of the hot spans
HOT = ("trainer.epoch", "trainer.adam", "trainer.tracking", "wrappers.",
       "kernels.")

_profiling = torch._C._autograd._profiler_enabled
_store = collections.deque(maxlen=STORE_SPANS)
_ids = itertools.count(1)
_local = threading.local()
_main_open = []  # the main thread's open spans, innermost last
_counts = {}
_count_lock = threading.Lock()


def _open_spans():
    """This thread's stack of open spans."""
    stack = getattr(_local, "open", None)
    if stack is None:
        stack = _local.open = (
            _main_open if threading.current_thread() is
            threading.main_thread() else [])
    return stack


class _Span:
    __slots__ = ("name", "id", "parent", "t0", "t1", "args", "device_ms",
                 "_stack", "_range", "_events")

    def __init__(self, name, args):
        self.name = name
        self.args = args
        self.t1 = self.device_ms = None
        self._range = self._events = None

    def __enter__(self):
        stack = self._stack = _open_spans()
        try:
            self.parent = (stack or _main_open)[-1].id
        except IndexError:
            self.parent = None
        self.id = next(_ids)
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def _close(self):
        """Take this span and any left open inside it off its stack; False
        when it was not open (closed already, or left open inside a span
        that has closed)."""
        if self.t1 is not None:
            return False
        self.t1 = time.perf_counter()
        stack = self._stack
        if stack and stack[-1] is self:
            stack.pop()
            return True
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i:]
                return True
        return False

    def __exit__(self, *exc):
        if self._close():
            _store.append(self)
        return False


class _HotSpan(_Span):
    __slots__ = ()

    def __enter__(self):
        self._range = torch._C._profiler._RecordFunctionFast(self.name)
        self._range.__enter__()
        super().__enter__()
        if torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record()
        kept = self._close() and _profiling()
        self._range.__exit__(*exc)
        self._range = None
        if kept:
            _store.append(self)
        return False


_OFF = contextlib.nullcontext()


def span(name, **args):
    """A span called ``name``; ``args`` (a fit-level span's only) are kept
    with it.  A hot span (``HOT``) with no profiler recording is a shared
    no-op context."""
    if name.startswith(HOT):
        return _HotSpan(name, None) if _profiling() else _OFF
    return _Span(name, args or None)


def spanned(name):
    """Decorator: each call of the function inside ``span(name)``."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*a, **kw):
            with span(name):
                return fn(*a, **kw)
        return run
    return deco


def close(name):
    """Close the innermost span called ``name`` open in this thread, if any
    (a span that ends where no block does: ``trainer.setup`` at a fit's
    first epoch)."""
    for s in reversed(_open_spans()):
        if s.name == name:
            s.__exit__(None, None, None)
            return


def spans():
    """[{name, id, parent, t0, t1, device_ms[, args]}] of the store, oldest
    first.  Waits for the device work of spans not yet read."""
    out = []
    for s in list(_store):
        if s._events is not None:
            start, end = s._events
            end.synchronize()
            s.device_ms = start.elapsed_time(end)
            s._events = None
        rec = {"name": s.name, "id": s.id, "parent": s.parent, "t0": s.t0,
               "t1": s.t1, "device_ms": s.device_ms}
        if s.args:
            rec["args"] = dict(s.args)
        out.append(rec)
    return out


def clear():
    """Empty the store."""
    _store.clear()


def count(name, n=1):
    """Add ``n`` to the counter ``name`` (0 registers it)."""
    with _count_lock:
        _counts[name] = _counts.get(name, 0) + n


def counters():
    """{name: count} of every counter."""
    with _count_lock:
        return dict(_counts)


def launches(module):
    """{direction: launches} of ``launches.<module>.*``, the counters of
    ``wire_tpu_torch.ops.<module>`` (imported first: it registers each of
    its directions at 0)."""
    importlib.import_module(f"wire_tpu_torch.ops.{module}")
    head = f"launches.{module}."
    return {k[len(head):]: v for k, v in counters().items()
            if k.startswith(head)}


@contextlib.contextmanager
def trace(log_dir):
    """Profile the block with torch.profiler (CPU, and CUDA where there is
    a card), write a TensorBoard trace under ``log_dir`` and, on exit,
    ``log_dir/spans.json``: {"spans": spans(), "counters": counters()}.
    Yields the profiler, whose ``key_averages()`` the caller may read."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump({"spans": spans(), "counters": counters()}, f)
