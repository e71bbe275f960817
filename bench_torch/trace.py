"""The traced slice: a ``torch.profiler`` recording of a fixed piece of
work after the measured window, reduced to what the per-layer readers ask.

The profiler's Chrome trace is read back as plain events (``ts`` and
``dur`` in microseconds on one clock for host and device):

* device activity: kernels, copies and sets (``cat`` kernel, gpu_memcpy,
  gpu_memset);
* host ranges: ``cpu_op`` and ``user_annotation`` (``record_function``)
  events, and the CUDA runtime calls that launch device work, tied to the
  device activity by their ``correlation`` id.

The slice is the span of the ``bench.slice`` range, which the driver opens
before the work and closes after a synchronize. Busy time is the union of
device intervals inside it, never a sum.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
SLICE = "bench.slice"


@contextlib.contextmanager
def profiled_slice(torch):
    """``with profiled_slice(torch) as box:`` profiles the block (CPU and
    CUDA activity) inside a ``bench.slice`` range that ends after a
    synchronize; ``box["trace"]`` is the :class:`Trace` afterwards."""
    from torch.profiler import ProfilerActivity, profile, record_function

    box: Dict[str, object] = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(SLICE):
            box["t_open"] = time.perf_counter()
            yield box
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            box["trace"] = Trace(json.load(f)["traceEvents"], box["t_open"])
    finally:
        os.unlink(path)


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    return sum(e - s for s, e in merge(intervals))


def merge(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Trace:
    """Complete events of one profiled slice (times in microseconds)."""

    def __init__(self, events: Sequence[dict], t_open: Optional[float] = None):
        self.t_open = t_open  # time.perf_counter() when the slice's range opened
        full = [e for e in events if e.get("ph") == "X" and "ts" in e]
        self.device = [e for e in full if e.get("cat") in DEVICE_CATS]
        self.host = [e for e in full if e.get("cat") in HOST_CATS]
        self.launches = {}
        for e in full:
            if e.get("cat") in ("cuda_runtime", "cuda_driver"):
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    self.launches[corr] = e
        spans = [e for e in self.host if e.get("name") == SLICE]
        if spans:
            s = spans[0]
            self.t0, self.t1 = float(s["ts"]), float(s["ts"]) + float(s["dur"])
        elif full:
            self.t0 = min(float(e["ts"]) for e in full)
            self.t1 = max(float(e["ts"]) + float(e.get("dur", 0)) for e in full)
        else:
            self.t0 = self.t1 = 0.0

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _clipped(self, events) -> List[Tuple[float, float]]:
        out = []
        for e in events:
            s = max(float(e["ts"]), self.t0)
            t = min(float(e["ts"]) + float(e["dur"]), self.t1)
            if t > s:
                out.append((s, t))
        return out

    @property
    def busy_s(self) -> float:
        """Seconds of the slice in which some device operation ran."""
        return union_length(self._clipped(self.device)) * 1e-6

    def idle_share(self) -> Optional[float]:
        if self.window_s <= 0 or not self.device:
            return None
        return 1.0 - self.busy_s / self.window_s

    def kernels(self, substrings: Sequence[str]) -> List[dict]:
        return [e for e in self.device if e.get("cat") == "kernel" and any(k in e["name"] for k in substrings)]

    def kernel_s(self, substrings: Sequence[str]) -> float:
        return sum(float(e["dur"]) for e in self.kernels(substrings)) * 1e-6

    def launched_within(self, spans: Sequence[Tuple[float, float]]) -> float:
        """Device seconds of the operations launched, from any host thread,
        inside ``spans`` of ``time.perf_counter()`` taken during the slice.
        The profiler records host ops only on the thread that started it;
        the runtime's launch calls it records on every thread."""
        if self.t_open is None:
            return 0.0
        us = sorted(((s - self.t_open) * 1e6 + self.t0, (e - self.t_open) * 1e6 + self.t0) for s, e in spans)
        starts = [s for s, _ in us]
        total = 0.0
        for e in self.device:
            launch = self.launches.get(e.get("args", {}).get("correlation"))
            if launch is None:
                continue
            lt = float(launch["ts"])
            i = bisect.bisect_right(starts, lt) - 1
            if i >= 0 and lt <= us[i][1]:
                total += float(e["dur"])
        return total * 1e-6

    def top_device_ops(self, n: int = 10) -> List[list]:
        """The ``n`` device operations that took most time, by name."""
        by_name: Dict[str, float] = {}
        for e in self.device:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[_short(k), v * 1e-6] for k, v in ranked]

    def _host_doing(self, tid, t: float) -> str:
        """The innermost host range on thread ``tid`` open at time ``t``."""
        best = None
        for e in self.host:
            if e["tid"] == tid and e["ts"] <= t <= e["ts"] + e["dur"] and e["name"] != SLICE:
                if best is None or e["dur"] < best["dur"]:
                    best = e
        return _short(best["name"]) if best is not None else "host, no op recorded on the launching thread"

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest idle gaps of the device inside the slice, each
        named by what the host was doing when it launched the operation
        that ended the gap."""
        intervals = merge(self._clipped(self.device))
        if not intervals:
            return []
        starts = sorted((float(e["ts"]), e) for e in self.device)
        keys = [s for s, _ in starts]
        edges = [(self.t0, self.t0)] + intervals + [(self.t1, self.t1)]
        gaps = [(nxt - end, nxt) for (_, end), (nxt, _) in zip(edges, edges[1:]) if nxt > end]
        gaps.sort(key=lambda g: -g[0])
        out = []
        for length, nxt in gaps[:n]:
            i = bisect.bisect_left(keys, nxt)
            label = "end of the slice"
            if i < len(starts) and nxt < self.t1:
                launch = self.launches.get(starts[i][1].get("args", {}).get("correlation"))
                label = self._host_doing(launch["tid"], float(launch["ts"])) if launch else "unlaunched"
            out.append([label, length * 1e-6])
        return out


def _short(name: str, limit: int = 120) -> str:
    return name if len(name) <= limit else name[: limit - 3] + "..."
