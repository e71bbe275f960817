"""K7's share of its roofline in the traced batch: the least time of the
batch's sparse-MoE combines (each token's k expert rows and shared row read
and one row written, over HBM bandwidth; ``bench_torch.flops_moe``) over
the device time of K7's kernels, in percent. Silent where the trace holds
no K7 kernel."""


def read(obs):
    trace = obs.get("trace")
    if trace is None or "slice_k7_bound_s" not in obs:
        return None
    t = trace.kernel_s(obs["k7_kernels"])
    if t <= 0:
        return None
    return 100.0 * obs["slice_k7_bound_s"] / t
