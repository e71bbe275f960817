"""The device time of the operations launched while the served VAE's
``decode`` ran (the benchmark times each call on the host and maps the
spans onto the trace's clock), over the device's busy time in the traced
slice, in percent."""


def read(obs):
    trace = obs.get("trace")
    if trace is None or not obs.get("decode_spans") or trace.busy_s <= 0:
        return None
    t = trace.launched_within(obs["decode_spans"])
    return 100.0 * t / trace.busy_s if t > 0 else None
