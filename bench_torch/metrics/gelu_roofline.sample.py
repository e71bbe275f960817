"""K6G's share of its roofline in the traced batch: the least time of the
batch's GELU passes (each MLP row read and written once, over HBM
bandwidth; ``bench_torch.flops_flux``) over the device time of K6G's
kernels, in percent. Silent where the trace holds no K6G kernel."""


def read(obs):
    trace = obs.get("trace")
    if trace is None or "slice_gelu_bound_s" not in obs:
        return None
    t = trace.kernel_s(obs["gelu_kernels"])
    if t <= 0:
        return None
    return 100.0 * obs["slice_gelu_bound_s"] / t
