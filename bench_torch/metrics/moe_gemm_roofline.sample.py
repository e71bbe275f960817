"""The routed expert GEMMs' share of their roofline in the traced batch:
their least time (FLOPs over the bf16 peak or weights and rows over HBM
bandwidth, the larger, ``bench_torch.flops_moe``) over the device time of
the grouped-GEMM kernels, in percent. Silent where the trace holds none."""


def read(obs):
    trace = obs.get("trace")
    if trace is None or "slice_moe_gemm_bound_s" not in obs:
        return None
    t = trace.kernel_s(obs["moe_gemm_kernels"])
    if t <= 0:
        return None
    return 100.0 * obs["slice_moe_gemm_bound_s"] / t
