"""K8W's share of its roofline in the traced batch: the least time of the
batch's full-width QK-RMSNorm passes (each row of q and k read and written
in place, over HBM bandwidth; ``bench_torch.flops_wan``) over the device
time of K8W's kernels, in percent. Silent where the trace holds no K8W
kernel."""


def read(obs):
    trace = obs.get("trace")
    if trace is None or "slice_qkw_bound_s" not in obs:
        return None
    t = trace.kernel_s(obs["qkw_kernels"])
    if t <= 0:
        return None
    return 100.0 * obs["slice_qkw_bound_s"] / t
