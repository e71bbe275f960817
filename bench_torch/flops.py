"""The benchmark's arithmetic: model FLOPs, the attention kernels' bounds
and the card's peaks.

Convention: one multiply-add is 2 FLOPs, and only matmul terms count
(elementwise and norm work is bound by bytes). :func:`fit_forward_flops`
is the dense count of ``fit_tpu_torch.utils.flops.fit_forward_flops``,
copied so that the program cannot move the yardstick.

The attention bounds count what the inputs need: valid queries against
valid keys (``len**2`` a row, not ``T * len``), each input byte read once
and each output byte written once, for valid tokens only.
"""

from __future__ import annotations

from typing import Iterable, Tuple

# NVIDIA's data sheet, H100 SXM5 80 GB, dense (no sparsity), at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def fit_forward_flops(
    hidden_size: int,
    depth: int,
    num_heads: int,
    t: int,
    mlp_ratio: float = 4.0,
    patch_dim: int = 16,
    freq_dim: int = 256,
) -> float:
    """Matmul FLOPs of one FiT forward of one row at ``t`` tokens: qkv,
    proj, the SwiGLU FFN at 2/3 width, scores and attention-weighted values
    over all ``t`` keys, RoPE as two (H*T, d) @ (d, d) products, adaLN, the
    embedders and the final projection."""
    d = hidden_size
    dh = int(d * mlp_ratio * 2 / 3)
    head_dim = d // num_heads
    dense = depth * t * (2 * d * 3 * d + 2 * d * d + 3 * 2 * d * dh)
    attention = depth * 4 * t * t * d
    rope = depth * 2 * (2 * t * d * head_dim)
    cond = (
        depth * 2 * d * 6 * d
        + t * 2 * patch_dim * d
        + 2 * freq_dim * d + 2 * d * d
        + 2 * d * 2 * d
        + t * 2 * d * patch_dim
    )
    return float(dense + attention + rope + cond)


def rows_forward_flops(model: dict, lengths: Iterable[int]) -> float:
    """Forward FLOPs of a batch whose rows have these valid token counts."""
    patch_dim = model["patch_size"] ** 2 * model["in_channels"]
    return sum(
        fit_forward_flops(model["hidden_size"], model["depth"], model["num_heads"], int(n),
                          model["mlp_ratio"], patch_dim)
        for n in lengths
    )


def bound_s(work: Tuple[float, float]) -> float:
    """Least time of (FLOPs, bytes): the larger of FLOPs over the bf16
    peak and bytes over HBM bandwidth."""
    return max(work[0] / PEAK_BF16_FLOPS, work[1] / PEAK_HBM_BYTES)


def k1_work(lengths: Iterable[int], num_heads: int, head_dim: int, elem_bytes: int = 2,
            with_lse: bool = False) -> Tuple[float, float]:
    """(FLOPs, bytes) one K1 call (RoPE attention forward) needs: two
    products of ``2 * len**2 * d`` a (row, head); reads q, k, v and the
    cos/sin tables (fp32, d wide each) of the valid tokens and the lengths,
    writes the valid rows' output (and their fp32 lse)."""
    lengths = [int(n) for n in lengths]
    tokens = sum(lengths)
    c = num_heads * head_dim
    flops = 2 * sum(2 * n * n * head_dim * num_heads for n in lengths)
    nbytes = tokens * (3 * c * elem_bytes + 2 * head_dim * 4 + c * elem_bytes) + 4 * len(lengths)
    if with_lse:
        nbytes += tokens * num_heads * 4
    return float(flops), float(nbytes)


def k2_work(lengths: Iterable[int], num_heads: int, head_dim: int, elem_bytes: int = 2) -> Tuple[float, float]:
    """(FLOPs, bytes) one K2 call (all three passes of the RoPE attention
    backward) needs: five products of ``2 * len**2 * d`` a (row, head);
    reads q, k, v, the output gradient, the output, the fp32 lse and the
    tables of the valid tokens and the lengths, writes their dq, dk, dv."""
    lengths = [int(n) for n in lengths]
    tokens = sum(lengths)
    c = num_heads * head_dim
    flops = 5 * sum(2 * n * n * head_dim * num_heads for n in lengths)
    reads = tokens * (3 * c * elem_bytes + 2 * c * elem_bytes + num_heads * 4 + 2 * head_dim * 4) + 4 * len(lengths)
    writes = tokens * 3 * c * elem_bytes
    return float(flops), float(reads + writes)


def k1_bound_s(lengths, num_heads: int, head_dim: int, elem_bytes: int = 2, with_lse: bool = False) -> float:
    return bound_s(k1_work(lengths, num_heads, head_dim, elem_bytes, with_lse))


def k2_bound_s(lengths, num_heads: int, head_dim: int, elem_bytes: int = 2) -> float:
    return bound_s(k2_work(lengths, num_heads, head_dim, elem_bytes))
