"""The device time of the operations launched inside the server's decode
steps (the program's ``serve.decode`` spans, mapped onto the trace's
clock), over the device's busy time in the traced slice, in percent.
Silent where the program records no such span."""


def read(obs):
    trace = obs.get("trace")
    if trace is None or trace.t_open is None or trace.busy_s <= 0:
        return None
    try:
        from fit_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    spans = [(e.t0, e.t1) for e in recorded(trace.t_open, trace.t_open + trace.window_s)
             if e.kind == "span" and e.name == "serve.decode"]
    if not spans:
        return None
    return 100.0 * trace.launched_within(spans) / trace.busy_s
