"""Profiling: the program's own spans and counts, ``torch.profiler``
traces, and a timing harness that waits for the card.

Counterpart of ``fit_tpu/utils/profiling.py``. A trace is a Chrome trace
(``chrome://tracing`` or Perfetto) of the host and, with a card, its
kernels. ``timeit`` times work on the card with CUDA events around each
call, and work on the CPU with the host clock.

The recorder keeps what the program's layers say about themselves in
memory: spans (``span``, ``record``) and timestamped counts (``count``),
the last 65,536 of them. Its times are ``time.perf_counter()`` seconds,
the clock of a ``torch.profiler`` trace's events: a span taken at
``perf_counter()`` t lies at ``(t - t_open) * 1e6`` microseconds past a
trace range opened at ``t_open``, and the device work a span launched is
that whose CUDA runtime call falls inside it. Its thread ids are native
(``threading.get_native_id()``), the ids of the trace's host ops; the
trace gives the runtime calls of a thread it records no host op on the id
derived from ``pthread_self()`` instead. ``torch.profiler`` records host
ranges only on the thread that started it; the recorder records on every
thread.

Spans the program records (each with the id it shares), and what reads
them:

* ``serve.collect``, ``serve.noise``, ``serve.enqueue``, ``serve.decode``
  (``rows``, ``images``), ``serve.readback``: the ``SamplingServer``
  worker's loop, batch id; together they cover the worker's time, one at a
  time (the benchmark's ``idle_collect.serve``, ``idle_host.serve``,
  ``decode_share.serve``).
* ``serve.await``, ``serve.answer``: its completer thread, blocked on a
  batch's event and answering it, batch id (read by no metric).
* ``serve.warmup``: ``SamplingServer.warmup``, whose end opens the
  window ``decode_useful.serve`` counts over.
* ``train.loader_wait``: the ``Trainer`` loop's thread blocked on its
  loader (its ``loader_wait_share`` log field; ``loader_wait_share.train``).

Counts: ``serve.images`` (requests answered) and ``vae.decoded_rows``
(rows decoded, padding included), read by ``decode_useful.serve``;
``serve.answered_ahead`` (requests of a batch answered while the worker
was launching a later one, else 0), read with ``serve.images`` by
``answered_ahead.serve``.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

__all__ = [
    "trace", "timeit", "force_completion", "Entry", "Recorder", "RECORDER", "span", "record", "count", "recorded",
    "enable", "enabled", "clear",
]

SPAN, COUNT = "span", "count"


class Entry(NamedTuple):
    """One span or count: ``t0 == t1`` for a count, whose ``attrs["n"]``
    is its amount."""

    name: str
    kind: str  # SPAN or COUNT
    tid: int  # threading.get_native_id() of the recording thread
    t0: float  # time.perf_counter() seconds
    t1: float
    id: object  # what the entry shares with others: a batch's or a request's id
    attrs: dict


class _Span:
    __slots__ = ("_rec", "name", "id", "attrs", "t0")

    def __init__(self, rec: "Recorder", name: str, id, attrs: dict):
        self._rec, self.name, self.id, self.attrs = rec, name, id, attrs

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._rec._append(self.name, SPAN, self.t0, time.perf_counter(), self.id, self.attrs)
        return False


class Recorder:
    """A bounded in-memory buffer of spans and counts. Appends from any thread; a span costs two clock reads
    and one append (``record_function`` costs several times that even with
    no profiler running, so it is not used here)."""

    def __init__(self, maxlen: int = 65_536):
        self._entries: "collections.deque[Entry]" = collections.deque(maxlen=maxlen)
        self.on = True

    def _append(self, name, kind, t0, t1, id, attrs) -> None:
        if self.on:
            # the thread object's native id: threading.get_native_id() is a
            # system call each time, which costs microseconds on some hosts
            tid = threading.current_thread().native_id
            self._entries.append(Entry(name, kind, tid, t0, t1, id, attrs))

    def span(self, name: str, id=None, **attrs) -> _Span:
        """``with rec.span(name, id, **attrs) as s:`` records the block's
        interval on exit (``s.id`` and ``s.attrs`` may be set inside it)."""
        return _Span(self, name, id, attrs)

    def record(self, name: str, t0: float, t1: float, id=None, **attrs) -> None:
        """Record an interval measured elsewhere, e.g. one whose ends fall
        on different threads."""
        self._append(name, SPAN, t0, t1, id, attrs)

    def count(self, name: str, n: int = 1, id=None) -> None:
        """Record ``n`` of ``name`` now."""
        t = time.perf_counter()
        self._append(name, COUNT, t, t, id, {"n": n})

    def recorded(self, t0: Optional[float] = None, t1: Optional[float] = None) -> List[Entry]:
        """The entries held that overlap ``[t0, t1]`` (either end open when
        None), in the order they were recorded."""
        held = list(self._entries)  # one C-level copy, safe against appends from other threads
        return [e for e in held if (t1 is None or e.t0 <= t1) and (t0 is None or e.t1 >= t0)]

    def enable(self, on: bool = True) -> bool:
        """Turn recording of entries on or off; returns the previous setting."""
        was, self.on = self.on, bool(on)
        return was

    def clear(self) -> None:
        self._entries.clear()


RECORDER = Recorder()  # the program's recorder: on by default
span = RECORDER.span
record = RECORDER.record
count = RECORDER.count
recorded = RECORDER.recorded
enable = RECORDER.enable
clear = RECORDER.clear


def enabled() -> bool:
    return RECORDER.on


@contextlib.contextmanager
def trace(logdir: str):
    """``with trace("profile/"):`` records the block with ``torch.profiler``
    (the card's kernels too when there is one) and writes
    ``<logdir>/trace.json`` at its end. Yields the profiler, whose
    ``key_averages()`` sums time by operation and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _tensors(out):
    return [x for x in tree_leaves(out) if isinstance(x, torch.Tensor)]


def force_completion(out) -> None:
    """Wait until ``out`` (a tensor or a nest of them) is computed: a
    synchronize of the card that holds its first tensor; nothing on the CPU."""
    leaves = _tensors(out)
    if leaves and leaves[0].is_cuda:
        torch.cuda.synchronize(leaves[0].device)


def timeit(fn: Callable, *args, iters: int = 10, warmup: int = 2, **kwargs) -> dict:
    """Time ``fn(*args, **kwargs)``: {mean_ms, p50_ms, min_ms, iters}. Each
    call is timed by CUDA events on the stream when its output is on the
    card, else by the host clock around the call."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
        force_completion(out)
    on_card = any(x.is_cuda for x in _tensors(out)) if warmup else torch.cuda.is_available()
    times = []
    for _ in range(iters):
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args, **kwargs)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            force_completion(fn(*args, **kwargs))
            times.append(time.perf_counter() - t0)
    times = np.asarray(times)
    return {
        "mean_ms": float(times.mean() * 1e3),
        "p50_ms": float(np.median(times) * 1e3),
        "min_ms": float(times.min() * 1e3),
        "iters": iters,
    }
