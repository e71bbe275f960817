"""Requests the server answered while its worker was already launching a
later batch, over the requests answered, in the untraced window (the
program's ``serve.answered_ahead`` and ``serve.images`` counts), in
percent. The window runs from the end of the server's warm-up (its
``serve.warmup`` span) to the traced slice's opening, as
``decode_useful.serve`` counts it. Silent where the program counts no
``serve.answered_ahead`` there."""


def read(obs):
    trace = obs.get("trace")
    if trace is None or trace.t_open is None:
        return None
    try:
        from fit_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    entries = recorded(None, trace.t_open)
    warm = [e.t1 for e in entries if e.kind == "span" and e.name == "serve.warmup" and e.t1 <= trace.t_open]
    if not warm:
        return None
    window = [e for e in entries if e.kind == "count" and max(warm) <= e.t0 <= trace.t_open]
    ahead = [e.attrs["n"] for e in window if e.name == "serve.answered_ahead"]
    images = sum(e.attrs["n"] for e in window if e.name == "serve.images")
    return 100.0 * sum(ahead) / images if ahead and images else None
