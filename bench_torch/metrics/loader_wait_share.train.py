"""The share of the untraced window in which the Trainer's loop waited for
its loader's next host batch (the program's ``train.loader_wait`` spans),
in percent. The window is taken as the ``window_s`` seconds before the
traced slice opened: the profiler slows the loop's own host code, so the
slice would overstate the wait. Silent where the program records no such
span."""


def read(obs):
    trace = obs.get("trace")
    window = obs.get("window_s")
    if trace is None or trace.t_open is None or not window:
        return None
    try:
        from fit_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    t0, t1 = trace.t_open - window, trace.t_open
    waits = [min(e.t1, t1) - max(e.t0, t0) for e in recorded(t0, t1)
             if e.kind == "span" and e.name == "train.loader_wait"]
    return 100.0 * sum(waits) / window if waits else None
