"""The device's idle share of the traced slice: 1 - the union of its
kernels, copies and sets over the slice's span, in percent."""


def read(obs):
    trace = obs.get("trace")
    share = trace.idle_share() if trace is not None else None
    return None if share is None else 100.0 * share
