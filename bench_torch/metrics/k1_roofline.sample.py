"""K1's share of its roofline in the traced batch: the least time of the
batch's K1 calls (valid queries by valid keys, ``bench_torch.flops``)
over the device time of K1's kernels, in percent. Silent where the trace
holds no K1 kernel."""


def read(obs):
    trace = obs.get("trace")
    if trace is None or "slice_k1_bound_s" not in obs:
        return None
    t = trace.kernel_s(obs["k1_kernels"])
    if t <= 0:
        return None
    return 100.0 * obs["slice_k1_bound_s"] / t
