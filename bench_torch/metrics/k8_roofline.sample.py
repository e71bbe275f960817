"""K8's share of its roofline in the traced batch: the least time of the
batch's QK-RMSNorm passes (each row's q and k read and written, and in a
double block v copied, over HBM bandwidth; ``bench_torch.flops_flux``)
over the device time of K8's kernels, in percent. Silent where the trace
holds no K8 kernel."""


def read(obs):
    trace = obs.get("trace")
    if trace is None or "slice_k8_bound_s" not in obs:
        return None
    t = trace.kernel_s(obs["k8_kernels"])
    if t <= 0:
        return None
    return 100.0 * obs["slice_k8_bound_s"] / t
