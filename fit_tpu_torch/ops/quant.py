"""int8 (w8a8) path for sampling and serving.

Counterpart of ``fit_tpu/ops/quant.py``. The per-block projections listed in
:data:`QUANT_KERNEL_PATHS` hold symmetric per-output-channel int8 weights,
quantized offline by :func:`quantize_params` with the same numpy arithmetic
as ``fit_tpu`` (so weights and scales are bit-identical), and quantize their
activations per token at run time. The product accumulates in int32
(``torch._int_mm``, the library product, as ``fit_tpu`` left its
``dot_general`` to XLA) and is rescaled once in fp32.

The block's int8 feeds come from two fused epilogues, :func:`adaln_quant`
(LayerNorm + modulate + quantize, the qkv and fc1 feeds) and
:func:`silu_mul_quant` (SwiGLU product + quantize, the fc2 feed). On a CUDA
tensor they launch the quantizing variants of ``csrc/row_quant.cu`` or
raise; on a CPU tensor, or with ``plain=True``, they run the plain PyTorch
version beside them, which computes in fp32 as the Pallas kernels do.
``fit_tpu`` sends small activations through XLA instead
(``_FUSED_EPILOGUE_MIN_ROWS``, a TPU measurement); the port always uses the
kernels on the card.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fit_tpu_torch.ops import LAUNCHES
from fit_tpu_torch.ops.fused_adaln import launch_adaln, launch_silu_mul

__all__ = [
    "QUANT_KERNEL_PATHS",
    "Int8Linear",
    "adaln_quant",
    "adaln_quant_reference",
    "dynamic_quant",
    "int8_matmul",
    "is_quantized_artifact",
    "load_quantized",
    "quantize_model",
    "quantize_params",
    "save_quantized",
    "silu_mul_quant",
    "silu_mul_quant_reference",
]

# (parent module, projection) pairs that hold int8 weights under
# quant="int8"; embedders, adaLN, the final layer and the norms stay in the
# model's dtype.
QUANT_KERNEL_PATHS = (
    ("attn", "qkv"),
    ("attn", "proj"),
    ("ffn", "fc1_g"),
    ("ffn", "fc1_x"),
    ("ffn", "fc1"),
    ("ffn", "fc2"),
)

Quantized = Tuple[torch.Tensor, torch.Tensor]  # (int8 codes (..., K), fp32 scales (..., 1))


def _rowwise_quant(h: torch.Tensor) -> Quantized:
    """Per-row symmetric int8 of an fp32 tensor: ``h ~= q * scale``."""
    ax = h.abs().amax(dim=-1, keepdim=True)
    scale = ax.clamp_min(1e-12) * (1.0 / 127.0)
    q = torch.clamp(torch.round(h / scale), -127, 127).to(torch.int8)
    return q, scale


def dynamic_quant(x: torch.Tensor) -> Quantized:
    """Per-token symmetric int8: ``(x_i8, scale)`` with x ~= x_i8 * scale.
    Zero rows quantize to zeros (the scale is clamped away from 0)."""
    return _rowwise_quant(x.float())


def _int_mm(xq: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32. cuBLAS takes more than 16
    rows, so a shorter product is zero-padded to 32 rows on the card."""
    m = xq.shape[0]
    if xq.is_cuda and m <= 16:
        return torch._int_mm(F.pad(xq, (0, 0, 0, 32 - m)), w_t)[:m]
    return torch._int_mm(xq, w_t)


def int8_matmul(
    x: Union[torch.Tensor, Quantized],
    weight_i8: torch.Tensor,
    kernel_scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """(..., K) activation @ (N, K) int8 weight -> (..., N) in ``out_dtype``.

    ``x`` is a float activation (quantized here per token) or a
    pre-quantized ``(x_i8, scale)`` pair from :func:`adaln_quant` /
    :func:`silu_mul_quant`. The weight is stored (N, K) like an
    ``nn.Linear`` weight and enters the product transposed, column-major.
    int32 accumulation, then ``acc * (x_scale * kernel_scale) + bias`` in
    fp32 and one cast."""
    xq, sx = x if isinstance(x, tuple) else dynamic_quant(x)
    lead = xq.shape[:-1]
    acc = _int_mm(xq.reshape(-1, xq.shape[-1]), weight_i8.t()).reshape(*lead, -1)
    y = acc.float() * (sx * kernel_scale.float())
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


class Int8Linear(nn.Module):
    """The int8 counterpart of an ``nn.Linear`` (``fit_tpu``'s
    ``Int8Dense``). Buffers, not parameters, since nothing trains them:
    ``weight`` (N, K) int8, ``kernel_scale`` (N,) fp32 and ``bias`` (N,).
    A fresh module is structure only; its values come from
    :func:`quantize_params` through ``load_state_dict``."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.register_buffer("weight", torch.zeros((out_features, in_features), dtype=torch.int8, device=device))
        self.register_buffer("kernel_scale", torch.ones((out_features,), dtype=torch.float32, device=device))
        self.register_buffer("bias", torch.zeros((out_features,), dtype=torch.float32, device=device))

    def forward(self, x: Union[torch.Tensor, Quantized], out_dtype: torch.dtype) -> torch.Tensor:
        return int8_matmul(x, self.weight, self.kernel_scale, self.bias, out_dtype)


# --- the fused quant epilogues ---------------------------------------------


def adaln_quant_reference(x, shift, scale, eps: float = 1e-6) -> Quantized:
    """Plain version of ``_adaln_quant_kernel``: fp32 LayerNorm, modulate
    and per-row int8. x (B, T, D); shift, scale (B, D)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return _rowwise_quant(normed * (1.0 + scale.float()[:, None, :]) + shift.float()[:, None, :])


def silu_mul_quant_reference(gate, val) -> Quantized:
    """Plain version of ``_silu_mul_quant_kernel``: ``silu(gate) * val`` in
    fp32, then per-row int8."""
    return _rowwise_quant(F.silu(gate.float()) * val.float())


def adaln_quant(
    x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6, plain: bool = False
) -> Quantized:
    """``rowwise_int8(modulate(layer_norm_fp32(x), shift, scale))`` in one
    pass: the int8 feed of the qkv and fc1 projections. x: (B, T, D);
    shift/scale: (B, D). Returns ``(q (B, T, D) int8, scale (B, T, 1) f32)``."""
    if plain or x.device.type == "cpu":
        return adaln_quant_reference(x, shift, scale, eps)
    out = launch_adaln(x, shift, scale, eps, quant=True)
    LAUNCHES["adaln_quant"] += 1
    return out


def silu_mul_quant(gate: torch.Tensor, val: torch.Tensor, *, plain: bool = False) -> Quantized:
    """``rowwise_int8(silu(gate) * val)`` in one pass: the fc2 feed.
    gate, val: (B, T, H). Returns ``(q (B, T, H) int8, scale (B, T, 1) f32)``."""
    if plain or gate.device.type == "cpu":
        return silu_mul_quant_reference(gate, val)
    out = launch_silu_mul(gate, val, quant=True)
    LAUNCHES["silu_mul_quant"] += 1
    return out


# --- offline weight quantization -------------------------------------------


def _quantize_weight(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-channel int8 of an (N, K) weight over its fan-in
    axis, with ``fit_tpu``'s ``_quantize_kernel`` arithmetic (float32
    numpy, round half to even)."""
    w = np.asarray(w, np.float32)
    amax = np.max(np.abs(w), axis=-1, keepdims=True)
    scale = np.maximum(amax, 1e-12) / 127.0
    wq = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return wq, np.squeeze(scale, axis=-1)


def _is_quant_weight(key: str) -> bool:
    parts = key.split(".")
    return len(parts) >= 3 and parts[-1] == "weight" and (parts[-3], parts[-2]) in QUANT_KERNEL_PATHS


def quantize_params(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A float FiT state dict -> the int8 model's: every weight on
    :data:`QUANT_KERNEL_PATHS` becomes int8 with a ``kernel_scale`` beside
    it; everything else passes through. The flat qkv weight (3C, D) gets a
    (3C,) scale, ``fit_tpu``'s grouped (3, C) scale in the same order."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        if _is_quant_weight(key) and value.dtype != torch.int8:
            wq, scale = _quantize_weight(value.detach().float().cpu().numpy())
            out[key] = torch.from_numpy(wq).to(value.device)
            out[key.removesuffix("weight") + "kernel_scale"] = torch.from_numpy(scale).to(value.device)
        else:
            out[key] = value
    return out


def quantize_model(model, calib_batches=None, alpha: float = 0.5):
    """A float FiT -> a new int8 FiT (``quant="int8"``) on the same device,
    with the same compute dtype and the weights of :func:`quantize_params`.

    ``calib_batches`` (canvas-forward inputs ``(x, t, y, pos, mask)``, e.g.
    from ``fit_tpu_torch.ops.equalize.synthetic_calib_batch``): when given,
    SmoothQuant runs first: the float model is calibrated on them and its
    per-channel scales are folded into the weights (``equalize_params``,
    strength ``alpha``), which leaves the float function unchanged and
    lowers the int8 error where activations have outlier channels."""
    from fit_tpu_torch.models.fit import FiT

    state_dict = model.state_dict()
    if calib_batches is not None:
        from fit_tpu_torch.ops.equalize import calibrate, equalize_params

        state_dict = equalize_params(state_dict, calibrate(model, calib_batches), alpha=alpha)
    device = next(model.parameters()).device
    qmodel = FiT(**{**model.config, "quant": "int8", "dtype": model.dtype}, device=device)
    qmodel.load_state_dict(quantize_params(state_dict))
    qmodel.plain_kernels = model.plain_kernels
    return qmodel


# --- quantized artifacts: quantize once, serve many ------------------------


def save_quantized(path: str, state_dict: Mapping[str, torch.Tensor], meta: Optional[dict] = None) -> None:
    """Write an int8 state dict (from :func:`quantize_params`) to
    ``path/params.pt`` with a ``quant.json`` marker beside it."""
    os.makedirs(path, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, os.path.join(path, "params.pt"))
    with open(os.path.join(path, "quant.json"), "w") as f:
        json.dump({"scheme": "w8a8-int8", **(meta or {})}, f, indent=1)


def is_quantized_artifact(path: str) -> bool:
    return os.path.exists(os.path.join(path, "quant.json"))


def load_quantized(path: str) -> Tuple[Dict[str, torch.Tensor], dict]:
    """Read a :func:`save_quantized` artifact -> ``(state_dict, meta)``, with
    the saved dtypes (int8 weights, fp32 scales)."""
    with open(os.path.join(path, "quant.json")) as f:
        meta = json.load(f)
    state_dict = torch.load(os.path.join(path, "params.pt"), map_location="cpu", weights_only=True)
    return state_dict, meta
