"""Model FLOPs of the window's optimizer steps (3 x the forward at each
row's valid tokens, ``bench_torch.flops``; remat's second forward not
counted) over the window's device seconds, as a percentage of the H100's
dense bf16 peak."""

from bench_torch.flops import PEAK_BF16_FLOPS


def read(obs):
    if not obs.get("model_flops") or not obs.get("window_s"):
        return None
    return 100.0 * obs["model_flops"] / obs["window_s"] / PEAK_BF16_FLOPS
