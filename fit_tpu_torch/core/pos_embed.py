"""Positional-embedding tables for FiT: 2D sincos and 2D RoPE with VisionNTK.

Counterpart of ``fit_tpu/core/pos_embed.py``. The tables are small, depend
only on the image geometry and are built on the host in numpy, so the port
re-implements the same numpy code: ``fit_tpu.core`` cannot be imported
without jax. The arithmetic (dtypes, operation order) is kept identical so
the emitted tables are byte-equal to ``fit_tpu``'s.

RoPE table layout, for ``dim`` = head_dim: per token
``[w-axis: cos f0, sin f0, ..., h-axis: cos f0, sin f0, ...]``; the first
half of the head dim rotates by width positions, the second by height.

:func:`rope_ids_nd` is FLUX's N-axis RoPE (``EmbedND``): each token carries
one id per axis and each axis rotates its own run of pairs; it works on
torch tensors on their device, since the ids are the model's input.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "grid_positions_2d",
    "sincos_1d",
    "sincos_2d",
    "ntk_scaled_theta",
    "rope_freqs_1d_from_positions",
    "rope_freqs_2d",
    "rope_ids_nd",
    # the reference implementation's names for the same tables
    "get_1d_sincos_pos_embed",
    "get_2d_sincos_pos_embed",
    "precompute_freqs_cis_2d",
]


def grid_positions_2d(nh: int, nw: int) -> Tuple[np.ndarray, np.ndarray]:
    """Flattened (w, h) float32 positions of an nh x nw grid, row-major
    over (h, w): token ``i`` sits at ``(h=i//nw, w=i%nw)``."""
    grid_h = np.arange(nh, dtype=np.float32)
    grid_w = np.arange(nw, dtype=np.float32)
    pos_w, pos_h = np.meshgrid(grid_w, grid_h)
    return pos_w.reshape(-1), pos_h.reshape(-1)


def _sincos_from_positions(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """(M,) positions -> (M, embed_dim) ``[sin | cos]``, frequencies in float64."""
    if embed_dim % 2:
        raise ValueError(f"sincos embed_dim must be even, got {embed_dim}")
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000**omega
    angles = np.outer(pos, omega)
    return np.concatenate([np.sin(angles), np.cos(angles)], axis=1)


def sincos_1d(embed_dim: int, length: int) -> np.ndarray:
    """(length, embed_dim) float32 table of positions 0 .. length - 1."""
    return _sincos_from_positions(embed_dim, np.arange(length)).astype(np.float32)


def sincos_2d(embed_dim: int, nh: int, nw: Optional[int] = None) -> np.ndarray:
    """(nh*nw, embed_dim) float32 table, w-axis half first then h-axis."""
    nw = nh if nw is None else nw
    pos_w, pos_h = grid_positions_2d(nh, nw)
    emb_w = _sincos_from_positions(embed_dim // 2, pos_w)
    emb_h = _sincos_from_positions(embed_dim // 2, pos_h)
    return np.concatenate([emb_w, emb_h], axis=1).astype(np.float32)


def ntk_scaled_theta(theta: float, dim: int, pos: np.ndarray, max_length: int) -> float:
    """VisionNTK base: ``theta * s**(dim/(dim-2))`` with
    ``s = max(max(pos)/sqrt(max_length), 1)`` (identity within the budget)."""
    s = max(np.max(pos) / np.sqrt(max_length), 1.0)
    return theta * np.power(s, dim / (dim - 2))


def rope_freqs_1d_from_positions(
    dim: int, pos: np.ndarray, theta: float = 10000.0, max_length: Optional[int] = None
) -> np.ndarray:
    """(M, dim//2, 2) ``[cos, sin]`` pairs with ``f_j = theta**(-2j/dim)``.

    Without ``max_length`` the math is float32; the NTK-scaled theta is a
    float64 scalar and promotes the table to float64, exactly as in
    ``fit_tpu`` (callers cast at the boundary)."""
    if max_length is not None:
        theta = ntk_scaled_theta(theta, dim, pos, max_length)
    exponents = np.arange(0, dim, 2, dtype=np.float32)[: dim // 2] / dim
    freqs = 1.0 / theta**exponents
    angles = np.outer(pos, freqs)
    return np.stack([np.cos(angles), np.sin(angles)], axis=-1)


def rope_freqs_2d(
    dim: int,
    nh: int,
    nw: Optional[int] = None,
    theta: float = 10000.0,
    max_length: Optional[int] = None,
) -> np.ndarray:
    """(nh*nw, dim) interleaved ``(cos, sin)`` RoPE table.

    Each axis gets ``dim//2`` channels, w-axis pairs first. Passing
    ``max_length`` turns on VisionNTK (the inference path only).
    """
    nw = nh if nw is None else nw
    pos_w, pos_h = grid_positions_2d(nh, nw)
    pairs_w = rope_freqs_1d_from_positions(dim // 2, pos_w, theta, max_length)
    pairs_h = rope_freqs_1d_from_positions(dim // 2, pos_h, theta, max_length)
    pairs = np.concatenate([pairs_w, pairs_h], axis=1)
    return pairs.reshape(pairs.shape[0], -1)


def rope_ids_nd(ids, axes_dim: Sequence[int], theta: float = 10000.0):
    """FLUX's ``EmbedND`` as an interleaved (B, T, d) fp32 table for
    ``fit_tpu_torch.ops.rope_attention.split_rope_tables`` (d = sum of
    ``axes_dim``): from (B, T, n) position ids (a torch tensor), axis ``i``
    fills ``axes_dim[i] / 2`` pairs, in axis order, pair ``j`` of it
    ``(cos, sin)`` of ``ids[..., i] * theta**(-2j / axes_dim[i])``, computed
    in float64 and cast once, as FLUX's ``rope`` does. An all-zero id (FLUX's
    text tokens) gives the identity rotation."""
    import torch

    if ids.shape[-1] != len(axes_dim) or any(a % 2 for a in axes_dim):
        raise ValueError(f"ids (..., {ids.shape[-1]}) need one even axes_dim entry an axis, got {tuple(axes_dim)}")
    parts = []
    for i, dim in enumerate(axes_dim):
        omega = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float64, device=ids.device) / dim)
        angles = ids[..., i].to(torch.float64)[..., None] * omega
        parts.append(torch.stack([torch.cos(angles), torch.sin(angles)], dim=-1))
    return torch.cat(parts, dim=-2).flatten(-2).float()


get_1d_sincos_pos_embed = sincos_1d
get_2d_sincos_pos_embed = sincos_2d
precompute_freqs_cis_2d = rope_freqs_2d
