"""Analytic FLOP counts and the card's peak rates, for MFU and roofline
bounds.

Counterpart of ``fit_tpu/utils/flops.py``: the same count of a FiT forward,
by component, and a peak table keyed on ``torch.cuda.get_device_name()``.
Convention: one multiply-add is 2 FLOPs, and only matmul terms count
(elementwise and norm work is bound by bytes, not operations).

Peaks are NVIDIA's data-sheet figures for the H100 SXM (dense, no sparsity,
at its 700 W limit): 989 TFLOP/s bf16 on the tensor cores, 495 TFLOP/s
TF32, 67 TFLOP/s fp32 outside the tensor cores, and 3.35 TB/s of HBM. A
card set to a lower power limit runs below them.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

__all__ = ["FitFlops", "fit_forward_flops", "peak_flops", "peak_hbm_bw"]


@dataclasses.dataclass
class FitFlops:
    """Per-forward FLOPs of a FiT denoiser, split by component."""

    dense: float  # qkv / proj / FFN token matmuls
    attention: float  # q@k^T and attn@v
    rope: float  # rotation-as-matmul (d, d) applications to q and k
    cond: float  # adaLN modulation / embedders / final layer
    total: float
    # MoE only: the router and the one-hot dispatch/combine einsums
    # (btd,btec->becd and back), real matmuls contracting over T into E*C
    # slot columns: at capacity factor cf ~2*cf*T extra D-wide MACs per token
    # per block, the order of attention
    dispatch: float = 0.0

    def scaled(self, k: float) -> "FitFlops":
        return FitFlops(*(getattr(self, f.name) * k for f in dataclasses.fields(self)))


def fit_forward_flops(
    hidden_size: int,
    depth: int,
    num_heads: int,
    t: int,
    batch: int = 1,
    mlp_ratio: float = 4.0,
    patch_dim: int = 16,
    freq_dim: int = 256,
    ffn: str = "swiglu",
    moe_experts: int = 8,
    moe_capacity: float = 1.25,
    moe_dispatch: str = "einsum",
) -> FitFlops:
    """Matmul FLOPs of one FiT forward at sequence length ``t``.

    The components of a block: fused qkv (D -> 3D), the attention
    out-projection, SwiGLU at 2/3 width (three D <-> Dh matmuls), RoPE as
    two (H*T, d) @ (d, d) products (q and k), adaLN per sample (6D from D a
    block, 2D in the final layer), the x and t embedders and the final
    projection.

    ``ffn="moe"`` counts the Switch top-1 MoE FFN: the expert matmuls run
    over ``E * C`` capacity slots instead of ``t`` tokens (``C = ceil(t/E *
    moe_capacity)``), and the router plus, for ``moe_dispatch="einsum"``,
    the one-hot dispatch and combine contractions go to ``dispatch``.
    ``moe_dispatch="sort"`` moves tokens by argsort and gathers, which are
    no matmul work, so only the router remains. Any other ``ffn`` (``"mlp"``
    too) counts as the dense SwiGLU FFN, as in ``fit_tpu``.
    """
    d = hidden_size
    dh = int(d * mlp_ratio * 2 / 3)
    head_dim = d // num_heads

    per_token_proj = 2 * d * 3 * d + 2 * d * d  # qkv, proj
    per_token_ffn = 3 * 2 * d * dh  # swiglu fc1_g / fc1_x / fc2
    dispatch = 0.0
    if ffn == "moe":
        slots = moe_experts * max(1, math.ceil(t / moe_experts * moe_capacity))
        ffn_flops = depth * slots * per_token_ffn  # stacked-expert matmuls
        dispatch = depth * 2 * t * d * moe_experts  # router logits
        if moe_dispatch == "einsum":
            dispatch += depth * 2 * 2 * t * slots * d  # dispatch + combine over E*C slots
    else:
        ffn_flops = depth * t * per_token_ffn
    dense = depth * t * per_token_proj + ffn_flops

    attention = depth * (2 * t * t * d + 2 * t * t * d)  # scores + av, all heads
    rope = depth * 2 * (2 * t * d * head_dim)  # q and k: (H*T,d)@(d,d)

    cond = (
        depth * 2 * d * 6 * d  # per-sample adaLN per block
        + t * 2 * patch_dim * d  # x_embedder
        + 2 * freq_dim * d + 2 * d * d  # t_embedder MLP
        + 2 * d * 2 * d  # final adaLN
        + t * 2 * d * patch_dim  # final linear
    )
    total = dense + attention + rope + cond + dispatch
    return FitFlops(dense, attention, rope, cond, total, dispatch).scaled(batch)


# dense FLOP/s by compute type, and HBM bytes/s, by device name
_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12, "hbm": 3.35e12},
}
_DTYPES = {"bfloat16": "bfloat16", "float16": "bfloat16", "tf32": "tf32", "float32": "float32"}


def _device_kind() -> str:
    import torch

    return torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"


def peak_flops(device_kind: Optional[str] = None, dtype="bfloat16") -> Optional[float]:
    """Dense peak FLOP/s of the current (or named) device for ``dtype``
    ("bfloat16" or "float16" on the tensor cores, "tf32", "float32" outside
    the tensor cores; a ``torch.dtype`` is taken by name); None for a device
    the table does not know (the CPU too). ``$FIT_TPU_PEAK_FLOPS``
    overrides it."""
    env = os.environ.get("FIT_TPU_PEAK_FLOPS")
    if env:
        return float(env)
    name = str(dtype).removeprefix("torch.")
    if name not in _DTYPES:
        raise ValueError(f"no peak for dtype {dtype!r}: use one of {sorted(_DTYPES)}")
    hit = _PEAKS.get(device_kind if device_kind is not None else _device_kind())
    return hit[_DTYPES[name]] if hit else None


def peak_hbm_bw(device_kind: Optional[str] = None) -> Optional[float]:
    """HBM bandwidth (byte/s); None when unknown."""
    hit = _PEAKS.get(device_kind if device_kind is not None else _device_kind())
    return hit["hbm"] if hit else None
