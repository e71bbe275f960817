"""Profiling: ``torch.profiler`` traces and a timing harness that waits for
the card.

Counterpart of ``fit_tpu/utils/profiling.py``. A trace is a Chrome trace
(``chrome://tracing`` or Perfetto) of the host and, with a card, its
kernels. ``timeit`` times work on the card with CUDA events around each
call, and work on the CPU with the host clock.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

__all__ = ["trace", "timeit", "force_completion"]


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
