"""The arithmetic of the Wan2.1 cell: a forward's FLOPs, the parameter count,
the bounds of its self- and cross-attention calls, and the bytes of its
full-width QK-RMSNorm (K8W).

The convention of :mod:`bench_torch.flops`: one multiply-add is 2 FLOPs and
only matmul terms count; every video token attends to every other and to
every text row (the released t2v sampler masks nothing). A row kernel's
bytes count each input read once and each output written once.
"""

from __future__ import annotations

from typing import Tuple

from bench_torch.flops import bound_s, k1_work


def _widths(m: dict) -> Tuple[int, int, int]:
    return m["dim"], m["ffn_dim"], m["dim"] // m["num_heads"]


def patch_dim(m: dict) -> int:
    pf, ph, pw = m["patch_size"]
    return m["in_dim"] * pf * ph * pw


def param_count(m: dict) -> int:
    """Every parameter of the model, from its sizes."""
    d, f, _ = _widths(m)

    def lin(i, o):
        return i * o + o

    attn = 4 * lin(d, d) + 2 * d  # q, k, v, o and the two RMSNorm weights
    block = 2 * attn + 2 * d + lin(d, f) + lin(f, d) + 6 * d  # norm3, the FFN, the modulation
    out = patch_dim(m) // m["in_dim"] * m["out_dim"]
    outside = (lin(patch_dim(m), d) + lin(m["text_dim"], d) + lin(d, d) + lin(m["freq_dim"], d) + lin(d, d)
               + lin(d, 6 * d) + lin(d, out) + 2 * d)
    return m["num_layers"] * block + outside


def block_flops(m: dict, tokens: int, text: int) -> float:
    """One row through a block of ``tokens`` video tokens and ``text`` text
    rows: the self-attention's q, k, v and o and its scores and values over
    all ``tokens``; the cross-attention's q and o over the video tokens, k
    and v over the text rows, scores and values over all ``text``; the
    FFN."""
    d, f, _ = _widths(m)
    self_attn = tokens * 4 * 2 * d * d + 4 * tokens * tokens * d
    cross = tokens * 2 * 2 * d * d + text * 2 * 2 * d * d + 4 * tokens * text * d
    return float(self_attn + cross + tokens * 2 * 2 * d * f)


def forward_flops(m: dict, tokens: int, text: int) -> float:
    """One row's forward: the blocks, the patch, text and time embeddings
    (the time projection once) and the head over the video tokens."""
    d = m["dim"]
    out = patch_dim(m) // m["in_dim"] * m["out_dim"]
    outside = (tokens * 2 * patch_dim(m) * d + text * (2 * m["text_dim"] * d + 2 * d * d)
               + 2 * m["freq_dim"] * d + 2 * d * d + 2 * d * 6 * d + tokens * 2 * d * out)
    return m["num_layers"] * block_flops(m, tokens, text) + float(outside)


def self_attn_bound_s(m: dict, rows: int, tokens: int) -> float:
    """The least time of one forward's self-attention calls (K1 with RoPE,
    every row whole) over ``rows`` rows: every block's."""
    _, _, hd = _widths(m)
    return m["num_layers"] * bound_s(k1_work([tokens] * rows, m["num_heads"], hd))


def cross_attn_work(m: dict, rows: int, tokens: int, text: int, elem_bytes: int = 2) -> Tuple[float, float]:
    """(FLOPs, bytes) of one cross-attention call over ``rows`` rows: two
    products of ``2 * tokens * text * d`` a (row, head); reads q (the video
    tokens), k and v (the text rows) and the lengths, writes the output."""
    d = m["dim"]
    flops = rows * 2 * 2 * tokens * text * d
    nbytes = rows * (tokens * d * elem_bytes * 2 + text * d * elem_bytes * 2 + 4)
    return float(flops), float(nbytes)


def cross_attn_bound_s(m: dict, rows: int, tokens: int, text: int) -> float:
    """The least time of one forward's cross-attention calls: every
    block's."""
    return m["num_layers"] * bound_s(cross_attn_work(m, rows, tokens, text))


def qk_norm_bytes(m: dict, rows: int, tokens: int, text: int, elem_bytes: int = 2) -> float:
    """K8W's bytes in one forward: in each block the self-attention's q and
    k and the cross-attention's q (video tokens) and k (text rows), each
    row of D read and written in place, and each call's (D,) weight."""
    d = m["dim"]
    per_block = rows * (3 * tokens + text) * d * 2 * elem_bytes + 4 * d * elem_bytes
    return float(m["num_layers"] * per_block)


def qk_norm_bound_s(m: dict, rows: int, tokens: int, text: int) -> float:
    return bound_s((0.0, qk_norm_bytes(m, rows, tokens, text)))


def gelu_bytes(m: dict, rows: int, tokens: int, elem_bytes: int = 2) -> float:
    """K6G's bytes in one forward: each video token's FFN row (``ffn_dim``)
    read once and written once, in every block."""
    return float(m["num_layers"] * rows * tokens * 2 * m["ffn_dim"] * elem_bytes)


def gelu_bound_s(m: dict, rows: int, tokens: int) -> float:
    return bound_s((0.0, gelu_bytes(m, rows, tokens)))
