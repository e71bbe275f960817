"""Analytic FLOP counts, the card's peak rates, and the roofline bounds of
the port's kernels.

Counterpart of ``fit_tpu/utils/flops.py``: the same count of a FiT forward,
by component, and a peak table keyed on ``torch.cuda.get_device_name()``.
Convention: one multiply-add is 2 FLOPs, and only matmul terms count
(elementwise and norm work is bound by bytes, not operations).

Peaks are NVIDIA's data-sheet figures for the H100 SXM (dense, no sparsity,
at its 700 W limit): 989 TFLOP/s bf16 on the tensor cores, 495 TFLOP/s
TF32, 67 TFLOP/s fp32 outside the tensor cores, and 3.35 TB/s of HBM. A
card set to a lower power limit runs below them.

A kernel's bound (:func:`bound_us`) is the least time the card could take
for the work one call needs, given as (FLOPs, bytes) by :func:`k1_work`,
:func:`k2_work`, :func:`k2_pass_work` and :func:`row_work`. The attention
counts take valid queries against valid keys (``2 * len**2 * d`` a product,
row and head) and the bytes of valid tokens only, each input read once and
each output written once: what the inputs need, as ``bench_torch/flops.py``
counts it, not what a kernel does for the padding.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Iterable, Optional, Tuple

__all__ = [
    "FitFlops",
    "fit_forward_flops",
    "peak_flops",
    "peak_hbm_bw",
    "bound_us",
    "k1_work",
    "k2_work",
    "k2_pass_work",
    "row_work",
]

Work = Tuple[float, float]  # (FLOPs, bytes) of one call


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


def bound_us(work: Work, compute: str = "bfloat16", device_kind: Optional[str] = None) -> Tuple[float, str]:
    """The least time in µs the current (or named) device could take for
    ``work``, (FLOPs, bytes): the larger of the FLOPs over the peak rate of
    ``compute`` and the bytes over HBM bandwidth, and which of the two sets
    it, "operations" or "bytes". ``compute`` is a :func:`peak_flops` type,
    or "3xtf32": fp32-accurate products as three TF32 products each, at a
    third of the TF32 rate. Raises for a device the peak table does not
    know."""
    rate = peak_flops(device_kind, "tf32" if compute == "3xtf32" else compute)
    hbm = peak_hbm_bw(device_kind)
    if rate is None or hbm is None:
        raise ValueError(f"no peak rates for {device_kind if device_kind is not None else _device_kind()!r}")
    t_ops = work[0] / (rate / 3 if compute == "3xtf32" else rate)
    t_bytes = work[1] / hbm
    return max(t_ops, t_bytes) * 1e6, "bytes" if t_bytes >= t_ops else "operations"


def _attention_sizes(lengths: Iterable[int], heads: int, head_dim: int, elem_bytes: int):
    """(tokens, a (token, all heads) activation's bytes, pair products)
    of valid tokens: the products are ``2 * len**2 * d`` summed over rows
    and heads."""
    lengths = [int(n) for n in lengths]
    pair = sum(2 * n * n * head_dim * heads for n in lengths)
    return sum(lengths), heads * head_dim * elem_bytes, pair


def k1_work(lengths: Iterable[int], heads: int, head_dim: int, elem_bytes: int = 2, rope: bool = True,
            with_lse: bool = False) -> Work:
    """K1, the attention forward, over rows of these valid lengths: two
    products (scores and values); reads q, k, v, the RoPE tables (fp32,
    ``head_dim`` wide each; none with RoPE off) and the lengths, writes the
    output (and the fp32 lse a head)."""
    lengths = list(lengths)
    tokens, act, pair = _attention_sizes(lengths, heads, head_dim, elem_bytes)
    nbytes = tokens * (3 * act + act) + 4 * len(lengths)
    nbytes += tokens * 2 * head_dim * 4 if rope else 0
    nbytes += tokens * heads * 4 if with_lse else 0
    return float(2 * pair), float(nbytes)


def cross_work(q_tokens: Iterable[int], k_lengths: Iterable[int], heads: int, head_dim: int,
               elem_bytes: int = 2) -> Work:
    """K1's key loop over keys of their own (the cross entry, no RoPE), over
    rows of these query counts and valid key lengths: two products of ``2 *
    tq * lk * d`` a (row, head); reads q of every query and k and v of the
    valid keys and the lengths, writes the output."""
    pairs = list(zip(q_tokens, k_lengths))
    act = heads * head_dim * elem_bytes
    flops = sum(2 * 2 * int(tq) * int(lk) * head_dim * heads for tq, lk in pairs)
    nbytes = sum(int(tq) * 2 * act + int(lk) * 2 * act + 4 for tq, lk in pairs)
    return float(flops), float(nbytes)


def k2_work(lengths: Iterable[int], heads: int, head_dim: int, elem_bytes: int = 2) -> Work:
    """K2, the attention backward, all three passes: five products; reads
    q, k, v, the output gradient, the output, the fp32 lse, the tables and
    the lengths, writes dq, dk and dv."""
    lengths = list(lengths)
    tokens, act, pair = _attention_sizes(lengths, heads, head_dim, elem_bytes)
    reads = tokens * (3 * act + act + act + heads * 4 + 2 * head_dim * 4) + 4 * len(lengths)
    return float(5 * pair), float(reads + tokens * 3 * act)


def k2_pass_work(lengths: Iterable[int], heads: int, head_dim: int, elem_bytes: int = 2) -> Dict[str, Work]:
    """Each K2 pass alone, by its own inputs and outputs. The prologue
    reads q, k, the output gradient, the output, the tables and the lse and
    writes the rotated q and k and the head-major lse and delta (no
    products); the dk/dv pass reads those, v, the output gradient, the
    tables and the lengths, writes dk and dv and does 4 products (S, dP, dv,
    dk); the dq pass reads the same, writes dq and does 3 (S, dP, dq)."""
    lengths = list(lengths)
    tokens, row, pair = _attention_sizes(lengths, heads, head_dim, elem_bytes)
    act, tabs, stat = tokens * row, tokens * 2 * head_dim * 4, tokens * heads * 4
    reads = 2 * act + act + act + tabs + 2 * stat + 4 * len(lengths)
    return {
        "prologue": (0.0, float(4 * act + tabs + stat + 2 * act + 2 * stat)),
        "dkdv": (float(4 * pair), float(reads + 2 * act)),
        "dq": (float(3 * pair), float(reads + act)),
    }


def row_work(kernel: str, rows: int, width: int, batch: int = 1, elem_bytes: int = 2, top_k: int = 2) -> Work:
    """A row kernel over ``rows`` rows of ``width``, by its wrapper's name,
    each input read once (a batch row's shift, scale and gate once per
    batch row of ``batch``) and each output written once; no operations
    count, the arithmetic being far below the ridge. "adaln_quant" and
    "silu_mul_quant" write int8 codes and an fp32 scale a row;
    "adaln_residual" reads x and y and writes the new residual and the
    modulated row; "swiglu_halves" reads each row's ``[gate | up]``;
    "moe_combine" reads ``top_k`` expert rows a token (with an int64
    position and an fp32 weight each) and the shared expert's row, and
    writes one, ``rows`` being tokens; "qk_norm" reads and writes the
    ``width`` columns of a row it norms (``[q | k | v]`` into another
    buffer, or q and k in place; the learned scales, 2 x head dim, are
    left out); "gelu_glue" reads and writes a row of ``width``;
    "qk_norm_wide" reads and writes a row of q or k in place (its weight
    left out); "adaln_modulate_mixed" and "adaln_residual_mixed" are K5 and
    K5R on an fp32 stream (x, the conditioning and K5R's new x fp32) with
    bf16 results and K5R's bf16 branch, whatever ``elem_bytes``."""
    act = rows * width * elem_bytes
    cond = batch * width * elem_bytes
    f32, b16, cond32 = rows * width * 4, rows * width * 2, batch * width * 4
    codes = rows * width + rows * 4
    nbytes = {
        "adaln_quant": act + 2 * cond + codes,
        "adaln_modulate": act + 2 * cond + act,
        "adaln_residual": 4 * act + 3 * cond,
        "silu_mul_quant": 2 * act + codes,
        "swiglu_glue": 3 * act,
        "swiglu_halves": 3 * act,
        "moe_combine": (top_k + 2) * act + rows * top_k * (8 + 4),
        "qk_norm": 2 * act,
        "gelu_glue": 2 * act,
        "qk_norm_wide": 2 * act,
        "adaln_modulate_mixed": f32 + 2 * cond32 + b16,
        "adaln_residual_mixed": 2 * f32 + 2 * b16 + 3 * cond32,
    }[kernel]
    return 0.0, float(nbytes)
