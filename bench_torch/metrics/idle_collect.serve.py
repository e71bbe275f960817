"""The device's idle time in the traced slice while the server's worker
was collecting a batch (the program's ``serve.collect`` spans, mapped onto
the trace's clock), over the slice's span, in percent. Silent where the
program records no such span. ``idle_host.serve`` reads the worker's other
spans through this file's ``read_idle``."""

from bench_torch.trace import merge

SPANS = ("serve.collect",)


def program_entries(t0=None, t1=None):
    """The program's recorded entries that overlap ``[t0, t1]``; None
    where the program has no recorder."""
    try:
        from fit_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    return None if recorded is None else recorded(t0, t1)


def idle_within(trace, spans) -> float:
    """Seconds of the slice in which the device was idle and one of
    ``spans`` (``time.perf_counter()`` pairs) was open."""
    edges = [(trace.t0, trace.t0)] + merge(trace._clipped(trace.device)) + [(trace.t1, trace.t1)]
    idle = [(end, nxt) for (_, end), (nxt, _) in zip(edges, edges[1:]) if nxt > end]
    mapped = merge(((s - trace.t_open) * 1e6 + trace.t0, (e - trace.t_open) * 1e6 + trace.t0) for s, e in spans)
    total, j = 0.0, 0
    for s, e in idle:
        while j < len(mapped) and mapped[j][1] <= s:
            j += 1
        k = j
        while k < len(mapped) and mapped[k][0] < e:
            total += min(e, mapped[k][1]) - max(s, mapped[k][0])
            k += 1
    return total * 1e-6


def read_idle(obs, names):
    """The slice's device-idle time inside the program's spans ``names``,
    in percent of the slice."""
    trace = obs.get("trace")
    if trace is None or trace.t_open is None or trace.window_s <= 0 or not trace.device:
        return None
    entries = program_entries(trace.t_open, trace.t_open + trace.window_s)
    spans = [(e.t0, e.t1) for e in entries or () if e.kind == "span" and e.name in names]
    if not spans:
        return None
    return 100.0 * idle_within(trace, spans) / trace.window_s


def read(obs):
    return read_idle(obs, SPANS)
