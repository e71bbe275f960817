"""The cross-attention kernel's share of its roofline in the traced batch:
the least time of the batch's cross-attention calls (video tokens against
the text rows, every row attended; ``bench_torch.flops_wan``) over the
device time of its kernels, in percent. Silent where the trace holds no
such kernel."""


def read(obs):
    trace = obs.get("trace")
    if trace is None or "slice_xattn_bound_s" not in obs:
        return None
    t = trace.kernel_s(obs["xattn_kernels"])
    if t <= 0:
        return None
    return 100.0 * obs["slice_xattn_bound_s"] / t
