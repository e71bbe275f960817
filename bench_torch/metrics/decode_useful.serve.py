"""Requests answered over rows decoded in the untraced window (the
program's ``serve.images`` and ``vae.decoded_rows`` counts; a decode is
padded to the server's batch), in percent. The window runs from the end of
the server's warm-up (its ``serve.warmup`` span) to the traced slice's
opening: the slice starts on an empty server, whose first batches are
nearly empty. Silent where the program counts no decoded row there."""


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
    n = {"serve.images": 0, "vae.decoded_rows": 0}
    for e in entries:
        if e.kind == "count" and e.name in n and max(warm) <= e.t0 <= trace.t_open:
            n[e.name] += e.attrs["n"]
    return 100.0 * n["serve.images"] / n["vae.decoded_rows"] if n["vae.decoded_rows"] else None
