"""Patchify / unpatchify / canvas pad and unpad, as torch reshapes.

Counterpart of ``fit_tpu/core/geometry.py``. Latents are ``(N, C, H, W)``;
token sequences are ``(N, T, p*p*C)``, row-major over the ``(H/p, W/p)``
patch grid, with channel the fastest axis inside a token.
:func:`patchify_np` is the data pipeline's single-latent numpy version.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

__all__ = [
    "token_count",
    "patchify",
    "unpatchify",
    "patchify_np",
    "pad_tokens",
    "pad_latent_to_canvas",
    "unpad_latent",
]


def token_count(h: int, w: int, patch_size: int) -> int:
    """Number of tokens of an (h, w) latent at the given patch size."""
    return (h // patch_size) * (w // patch_size)


def patchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(N, C, H, W) -> (N, T, p*p*C) with T = (H/p)*(W/p)."""
    n, c, h, w = x.shape
    p = patch_size
    nh, nw = h // p, w // p
    x = x.reshape(n, c, nh, p, nw, p).permute(0, 2, 4, 3, 5, 1)
    return x.reshape(n, nh * nw, p * p * c)


def unpatchify(x: torch.Tensor, h: int, w: int, patch_size: int, channels: int) -> torch.Tensor:
    """(N, T, p*p*C) -> (N, C, h, w); the inverse of :func:`patchify`."""
    n = x.shape[0]
    p = patch_size
    nh, nw = h // p, w // p
    x = x.reshape(n, nh, nw, p, p, channels).permute(0, 5, 1, 3, 2, 4)
    return x.reshape(n, channels, nh * p, nw * p)


def patchify_np(latent: np.ndarray, patch_size: int) -> np.ndarray:
    """Host-side single-latent patchify: (C, H, W) -> (T, p*p*C), numpy."""
    c, h, w = latent.shape
    p = patch_size
    nh, nw = h // p, w // p
    latent = latent.reshape(c, nh, p, nw, p).transpose(1, 3, 2, 4, 0)  # (nh, nw, p, p, c)
    return latent.reshape(nh * nw, p * p * c)


def pad_tokens(tokens: Union[torch.Tensor, np.ndarray], max_length: int) -> torch.Tensor:
    """Zero-pad a (T, D) token array to (max_length, D) along the token
    axis, or cut it to its first ``max_length`` tokens."""
    tokens = torch.as_tensor(tokens)
    t = tokens.shape[0]
    if t >= max_length:
        return tokens[:max_length]
    return torch.cat([tokens, tokens.new_zeros((max_length - t,) + tuple(tokens.shape[1:]))])


def pad_latent_to_canvas(
    x: torch.Tensor, patch_size: int, max_size: int, max_length: int
) -> torch.Tensor:
    """Place an (N, C, H, W) latent's tokens at the front of a square
    (N, C, max_size, max_size) canvas, zeros after them. A latent with more
    than ``max_length`` tokens is returned as it is (it is its own canvas)."""
    n, c, _, _ = x.shape
    tokens = patchify(x, patch_size)
    if tokens.shape[1] > max_length:
        return x
    padded = x.new_zeros((n, max_length, patch_size * patch_size * c))
    padded[:, : tokens.shape[1]] = tokens
    return unpatchify(padded, max_size, max_size, patch_size, c)


def unpad_latent(
    x: torch.Tensor, valid_t: int, h: int, w: int, patch_size: int
) -> torch.Tensor:
    """Inverse of :func:`pad_latent_to_canvas`: the first ``valid_t`` tokens
    of the canvas, reshaped to (N, C, h, w)."""
    c = x.shape[1]
    tokens = patchify(x, patch_size)[:, :valid_t]
    return unpatchify(tokens, h, w, patch_size, c)
