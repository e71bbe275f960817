"""The arithmetic of the DiT-MoE cell: a forward's active FLOPs and the
bound of its routed expert GEMMs.

The convention of :mod:`bench_torch.flops`: one multiply-add is 2 FLOPs and
only matmul terms count. Active FLOPs are what a dropless top-k forward
computes: each token through the router, its k experts and the shared
expert, never through the experts it was not routed to.
"""

from __future__ import annotations

from typing import Iterable, Tuple

from bench_torch.flops import bound_s


def block_flops(m: dict, t: int) -> float:
    """Matmul FLOPs of one DiT-MoE block on one row of ``t`` tokens: qkv and
    proj, scores and attention-weighted values over all ``t`` keys, the
    router, the k routed SwiGLU experts (width ``4 D``) and the shared one,
    and the block's adaLN projection (once a row)."""
    d, e, k = m["hidden_size"], m["num_experts"], m["num_experts_per_tok"]
    h, s = int(d * m["mlp_ratio"]), m["shared_hidden"]
    dense = t * (2 * d * 3 * d + 2 * d * d)
    attention = 4 * t * t * d
    router = t * 2 * d * e
    experts = k * t * 3 * 2 * d * h
    shared = t * 3 * 2 * d * s
    return float(dense + attention + router + experts + shared + 2 * d * 6 * d)


def forward_flops(m: dict, t: int) -> float:
    """Matmul FLOPs of one forward of one row at ``t`` tokens: the blocks,
    the patch and timestep embedders, the final adaLN and projection."""
    d = m["hidden_size"]
    pdim = m["patch_size"] ** 2 * m["in_channels"]
    out = pdim * (2 if m.get("learn_sigma") else 1)
    outside = t * 2 * pdim * d + 2 * 256 * d + 2 * d * d + 2 * d * 2 * d + t * 2 * d * out
    return m["depth"] * block_flops(m, t) + float(outside)


def rows_forward_flops(m: dict, lengths: Iterable[int]) -> float:
    """Forward FLOPs of a batch whose rows have these token counts."""
    return sum(forward_flops(m, int(n)) for n in lengths)


def expert_gemm_work(m: dict, tokens: int, elem_bytes: int = 2) -> Tuple[float, float]:
    """(FLOPs, bytes) the routed expert GEMMs of one block need for
    ``tokens`` tokens: ``k * tokens`` rows through ``[gate | up]`` (D to 2H)
    and down (H to D); every expert's weights read once, the gathered rows
    read, the 2H-wide projection written, the H-wide product read and the
    D-wide output written once each."""
    d, e, k = m["hidden_size"], m["num_experts"], m["num_experts_per_tok"]
    h = int(d * m["mlp_ratio"])
    rows = k * tokens
    flops = rows * (2 * d * 2 * h + 2 * h * d)
    nbytes = elem_bytes * (e * 3 * d * h + rows * (d + 2 * h + h + d))
    return float(flops), float(nbytes)


def expert_gemm_bound_s(m: dict, tokens: int) -> float:
    """Least time of one block's routed expert GEMMs: FLOPs over the bf16
    peak or bytes over HBM bandwidth, the larger."""
    return bound_s(expert_gemm_work(m, tokens))


def combine_work(m: dict, tokens: int, elem_bytes: int = 2) -> Tuple[float, float]:
    """(FLOPs, bytes) of one block's combine (K7) for ``tokens`` tokens: k
    expert rows and the shared expert's row read and one row written a
    token, with its k int64 positions and fp32 weights; its multiply-adds
    are not matmul terms, so it is bound by bytes."""
    d, k = m["hidden_size"], m["num_experts_per_tok"]
    return 0.0, float(tokens * (elem_bytes * d * (k + 2) + k * (8 + 4)))


def combine_bound_s(m: dict, tokens: int) -> float:
    return bound_s(combine_work(m, tokens))
