"""The arithmetic of the FLUX cell: a forward's FLOPs, the parameter count,
and the bytes of its two row kernels, K8 (QK-RMSNorm) and K6G (GELU).

The convention of :mod:`bench_torch.flops`: one multiply-add is 2 FLOPs and
only matmul terms count; every token of both streams attends to every
other (no mask). A row kernel's bytes count each input read once and each
output written once.
"""

from __future__ import annotations

from typing import Tuple

from bench_torch.flops import bound_s


def _widths(m: dict) -> Tuple[int, int, int]:
    d = m["hidden_size"]
    return d, int(d * m["mlp_ratio"]), d // m["num_heads"]


def param_count(m: dict) -> int:
    """Every parameter of the model, from its sizes."""
    d, h, hd = _widths(m)

    def lin(i, o, bias=True):
        return i * o + (o if bias else 0)

    stream = lin(d, 6 * d) + lin(d, 3 * d, m["qkv_bias"]) + 2 * hd + lin(d, d) + lin(d, h) + lin(h, d)
    single = lin(d, 3 * d + h) + lin(d + h, d) + 2 * hd + lin(d, 3 * d)
    outside = (lin(m["in_channels"], d) + lin(256, d) + lin(d, d) + lin(m["vec_in_dim"], d) + lin(d, d)
               + lin(m["context_in_dim"], d) + lin(d, m["in_channels"]) + lin(d, 2 * d))
    return m["depth"] * 2 * stream + m["depth_single_blocks"] * single + outside


def double_block_flops(m: dict, tt: int, ti: int) -> float:
    """One image through a double block with ``tt`` text and ``ti`` image
    tokens: each stream's qkv, proj and MLP over its own tokens, its
    modulation once, and the joint attention's scores and values over all
    ``tt + ti``."""
    d, h, _ = _widths(m)
    t = tt + ti
    per_token = 2 * d * 3 * d + 2 * d * d + 2 * 2 * d * h
    return float(t * per_token + 2 * (2 * d * 6 * d) + 4 * t * t * d)


def single_block_flops(m: dict, t: int) -> float:
    """One image through a single block of ``t`` tokens: linear1, linear2,
    the modulation once, and attention over all ``t``."""
    d, h, _ = _widths(m)
    return float(t * (2 * d * (3 * d + h) + 2 * (d + h) * d) + 2 * d * 3 * d + 4 * t * t * d)


def forward_flops(m: dict, tt: int, ti: int) -> float:
    """One image's forward: the blocks, the four embedders and the last
    layer (its adaLN once, its projection over the image tokens)."""
    d = m["hidden_size"]
    c = m["in_channels"]
    outside = (ti * 2 * c * d + tt * 2 * m["context_in_dim"] * d + 2 * 256 * d + 2 * d * d
               + 2 * m["vec_in_dim"] * d + 2 * d * d + 2 * d * 2 * d + ti * 2 * d * c)
    return (m["depth"] * double_block_flops(m, tt, ti) + m["depth_single_blocks"] * single_block_flops(m, tt + ti)
            + float(outside))


def k8_bytes(m: dict, batch: int, tt: int, ti: int, elem_bytes: int = 2) -> float:
    """K8's bytes in one forward: in a double block each stream's rows read
    q, k and v and write them into the joint buffer; in a single block
    each row's q and k are read and written in place (v untouched); each
    call reads its two scales."""
    d, _, hd = _widths(m)
    rows = batch * (tt + ti)
    scales = 2 * hd * elem_bytes
    double = rows * 2 * 3 * d * elem_bytes + 2 * scales
    single = rows * 2 * 2 * d * elem_bytes + scales
    return float(m["depth"] * double + m["depth_single_blocks"] * single)


def gelu_bytes(m: dict, batch: int, tt: int, ti: int, elem_bytes: int = 2) -> float:
    """K6G's bytes in one forward: every token's MLP row (width ``mlp_ratio
    * D``) read once and written once, in each double block (both streams)
    and each single block."""
    _, h, _ = _widths(m)
    rows = batch * (tt + ti)
    return float((m["depth"] + m["depth_single_blocks"]) * rows * 2 * h * elem_bytes)


def k8_bound_s(m: dict, batch: int, tt: int, ti: int) -> float:
    return bound_s((0.0, k8_bytes(m, batch, tt, ti)))


def gelu_bound_s(m: dict, batch: int, tt: int, ti: int) -> float:
    return bound_s((0.0, gelu_bytes(m, batch, tt, ti)))
