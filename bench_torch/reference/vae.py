"""The SD-VAE decoder (kl-f8: channels 128/256/512/512, three res blocks a
level in the decoder, one single-head attention in the mid block,
GroupNorm(32, eps 1e-6), SiLU, nearest x2 upsampling) as plain fp32
functions of a weight dict, and the PNG conversion: clip (x + 1) / 2 to
[0, 1], scale by 255 and truncate to uint8, channels last."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from bench_torch.reference.precision import FP32, Precision

W = Dict[str, torch.Tensor]


def _conv(w: W, name: str, x, pr: Precision, padding: int):
    weight, bias = w[name + ".weight"], w[name + ".bias"]
    if pr is FP32:
        return F.conv2d(x, weight, bias, padding=padding)
    # the control: the convolution as a matmul over unfolded patches
    cout, cin, k, _ = weight.shape
    n, _, h, wd = x.shape
    cols = F.unfold(x, k, padding=padding).transpose(1, 2)  # (N, HW, cin*k*k)
    y = pr.linear(cols, weight.reshape(cout, -1), bias)
    return y.transpose(1, 2).reshape(n, cout, h, wd)


def _norm(w: W, name: str, x):
    return F.group_norm(x, min(32, x.shape[1]), w[name + ".weight"], w[name + ".bias"], eps=1e-6)


def _resnet(w: W, name: str, x, pr):
    h = _conv(w, name + ".conv1", F.silu(_norm(w, name + ".norm1", x)), pr, 1)
    h = _conv(w, name + ".conv2", F.silu(_norm(w, name + ".norm2", h)), pr, 1)
    if name + ".shortcut.weight" in w:
        x = _conv(w, name + ".shortcut", x, pr, 0)
    return x + h


def _attn(w: W, name: str, x, pr):
    n, c, h, wd = x.shape
    y = _norm(w, name + ".norm", x).reshape(n, c, h * wd).transpose(1, 2)
    q, k, v = (pr.linear(y, w[f"{name}.{p}.weight"], w[f"{name}.{p}.bias"]) for p in ("q", "k", "v"))
    att = torch.softmax(pr.matmul(q, k.transpose(1, 2)) * c**-0.5, dim=-1)
    y = pr.linear(pr.matmul(att, v), w[name + ".proj_out.weight"], w[name + ".proj_out.bias"])
    return x + y.transpose(1, 2).reshape(n, c, h, wd)


def decode(w: W, v: dict, z: torch.Tensor, pr: Precision = FP32) -> torch.Tensor:
    """(N, 3, 8h, 8w) images of unscaled latents ``z`` (N, 4, h, w)."""
    levels = len(v["block_out_channels"])
    x = _conv(w, "decoder.post_quant_conv", z, pr, 0)
    x = _conv(w, "decoder.conv_in", x, pr, 1)
    x = _resnet(w, "decoder.mid_block_1", x, pr)
    x = _attn(w, "decoder.mid_attn", x, pr)
    x = _resnet(w, "decoder.mid_block_2", x, pr)
    for i in range(levels):
        for j in range(v["decoder_layers_per_block"]):
            x = _resnet(w, f"decoder.up_{i}_block_{j}", x, pr)
        if i < levels - 1:
            x = _conv(w, f"decoder.up_{i}_upsample.conv", F.interpolate(x, scale_factor=2.0, mode="nearest"), pr, 1)
    return _conv(w, "decoder.conv_out", F.silu(_norm(w, "decoder.norm_out", x)), pr, 1)


def to_uint8(image: np.ndarray) -> np.ndarray:
    """(3, H, W) in [-1, 1] -> (H, W, 3) uint8."""
    img = np.clip((np.asarray(image, np.float32) + 1) / 2, 0, 1)
    return (np.moveaxis(img, 0, -1) * 255).astype(np.uint8)
