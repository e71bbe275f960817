"""K2's share of its roofline in the traced steps: the least time of the
steps' K2 calls (all three passes; valid queries by valid keys,
``bench_torch.flops``) over the device time of K2's kernels, in percent.
Silent where the trace holds no K2 kernel."""


def read(obs):
    trace = obs.get("trace")
    if trace is None or "slice_k2_bound_s" not in obs:
        return None
    t = trace.kernel_s(obs["k2_kernels"])
    if t <= 0:
        return None
    return 100.0 * obs["slice_k2_bound_s"] / t
