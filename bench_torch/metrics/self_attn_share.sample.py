"""The device time of the operations launched inside the program's Wan
self-attention (its ``wan.self_attn`` spans, one a block call), over the
device's busy time in the traced slice, in percent. The spans' perf_counter()
times are mapped onto the trace's clock through the driver's ``wan.clock``
marks, as many at the slice's start as at its end (``obs["clock_marks"]``),
and not through the slice's opening, which the profiler's first range of a
process stamps early. Of each end's marks the one with the largest offset
(trace time past perf_counter()) counts: a mark is read after its range is
stamped, so a delay between the two only lowers the offset. The offset is
interpolated between the ends. Silent where the program records no such span
or the driver no marks."""

CLOCK = "wan.clock"


def read(obs):
    trace = obs.get("trace")
    marks = obs.get("clock_marks")
    if trace is None or trace.t_open is None or trace.busy_s <= 0 or not marks or len(marks) % 2:
        return None
    stamps = sorted(float(e["ts"]) for e in trace.host if e.get("name") == CLOCK)
    if len(stamps) != len(marks):
        return None
    try:
        from fit_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    spans = [(e.t0, e.t1) for e in recorded(trace.t_open, trace.t_open + trace.window_s)
             if e.kind == "span" and e.name == "wan.self_attn"]
    if not spans:
        return None
    pairs = [(ts - m * 1e6, m) for m, ts in zip(marks, stamps)]  # (offset in µs, the mark)
    half = len(pairs) // 2
    (o0, m0), (o1, m1) = max(pairs[:half]), max(pairs[half:])

    def on_slice_clock(t):
        """perf_counter() ``t`` as the time ``launched_within`` maps through
        ``t_open`` onto the trace's clock where the marks put it."""
        offset = o0 if m1 == m0 else o0 + (o1 - o0) * (t - m0) / (m1 - m0)
        return trace.t_open + (t * 1e6 + offset - trace.t0) * 1e-6

    moved = [(on_slice_clock(s), on_slice_clock(e)) for s, e in spans]
    return 100.0 * trace.launched_within(moved) / trace.busy_s
