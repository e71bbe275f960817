"""Building blocks of the FiT denoiser as ``nn.Module``s.

Counterpart of ``fit_tpu/models/layers.py`` (dense SwiGLU blocks, RoPE
attention). Parameters may be stored in another dtype than the compute
dtype: every projection casts its weight to the activation's dtype, which is
a no-op once the sampler has cast the model (``fit_tpu_torch.sampling``).
Weights are ``nn.Linear`` (``weight`` is the flax kernel transposed);
``fit_tpu_torch.models.from_jax`` converts a flax param tree.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fit_tpu_torch.ops.rope_attention import qkv_rope_attention, rope_attention_reference

__all__ = [
    "modulate",
    "layer_norm_fp32",
    "linear",
    "TimestepEmbedder",
    "LabelEmbedder",
    "SwiGLU",
    "SelfAttention",
    "FiTBlock",
    "FinalLayer",
]


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """adaLN modulation ``x * (1 + scale) + shift``, (N, D) broadcast over tokens."""
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def layer_norm_fp32(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Affine-free LayerNorm with fp32 statistics, cast back to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)`` computed in x's dtype, whatever the parameters' dtype."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class TimestepEmbedder(nn.Module):
    """Scalar diffusion timestep -> (N, hidden) conditioning vector."""

    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256, device=None):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.fc1 = nn.Linear(frequency_embedding_size, hidden_size, device=device)
        self.fc2 = nn.Linear(hidden_size, hidden_size, device=device)

    @staticmethod
    def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
        """``[cos | sin]`` sinusoidal features in fp32 (cos first)."""
        half = dim // 2
        freqs = torch.exp(
            -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
        )
        args = t.float()[:, None] * freqs[None]
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        if dim % 2:
            emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
        return emb

    def forward(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = self.timestep_embedding(t, self.frequency_embedding_size).to(dtype)
        return linear(self.fc2, F.silu(linear(self.fc1, x)))


class LabelEmbedder(nn.Module):
    """Class-label embedding; row ``num_classes`` is the CFG null class."""

    def __init__(self, num_classes: int, hidden_size: int, dropout_prob: float, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.dropout_prob = dropout_prob
        self.table = nn.Embedding(num_classes + int(dropout_prob > 0), hidden_size, device=device)

    def forward(
        self,
        labels: torch.Tensor,
        train: bool,
        dtype: torch.dtype,
        force_drop_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if force_drop_ids is not None:
            labels = torch.where(force_drop_ids == 1, self.num_classes, labels)
        elif train and self.dropout_prob > 0:
            u = torch.rand(labels.shape, device=labels.device)
            labels = torch.where(u < self.dropout_prob, self.num_classes, labels)
        return self.table(labels).to(dtype)


class SwiGLU(nn.Module):
    """Gated FFN ``fc2(silu(fc1_g(x)) * fc1_x(x))``."""

    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.fc1_g = nn.Linear(dim, hidden, device=device)
        self.fc1_x = nn.Linear(dim, hidden, device=device)
        self.fc2 = nn.Linear(hidden, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self.fc2, F.silu(linear(self.fc1_g, x)) * linear(self.fc1_x, x))


class SelfAttention(nn.Module):
    """Multi-head self-attention with 2D RoPE and a prefix key mask.

    One flat qkv projection ``(D -> 3D)`` whose ``[q | k | v]`` output goes
    as it is into :func:`qkv_rope_attention`: the CUDA kernel on the card,
    its plain version on the CPU. ``plain=True`` runs the plain version on
    any device (the reference the kernel is held against).
    """

    def __init__(self, dim: int, num_heads: int, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, x, cos, sin, lengths, plain: bool = False) -> torch.Tensor:
        qkv = linear(self.qkv, x)
        scale = (x.shape[-1] // self.num_heads) ** -0.5
        if plain:
            out = rope_attention_reference(qkv, cos, sin, lengths, scale, self.num_heads)
        else:
            out = qkv_rope_attention(
                qkv, cos, sin, lengths, scale, self.num_heads, check_lengths=False
            )
        return linear(self.proj, out)


class FiTBlock(nn.Module):
    """Pre-LN transformer block with adaLN-Zero conditioning."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0, device=None):
        super().__init__()
        self.adaLN = nn.Linear(hidden_size, 6 * hidden_size, device=device)
        self.attn = SelfAttention(hidden_size, num_heads, device=device)
        self.ffn = SwiGLU(hidden_size, int(hidden_size * mlp_ratio * 2 / 3), device=device)

    def forward(self, x, c, cos, sin, lengths, plain: bool = False) -> torch.Tensor:
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = linear(
            self.adaLN, F.silu(c)
        ).chunk(6, dim=-1)
        attn_in = modulate(layer_norm_fp32(x), shift_msa, scale_msa)
        x = x + gate_msa[:, None, :] * self.attn(attn_in, cos, sin, lengths, plain)
        ffn_in = modulate(layer_norm_fp32(x), shift_mlp, scale_mlp)
        return x + gate_mlp[:, None, :] * self.ffn(ffn_in)


class FinalLayer(nn.Module):
    """LayerNorm, 2-way adaLN modulate, then a projection to patches."""

    def __init__(self, hidden_size: int, patch_size: int, out_channels: int, device=None):
        super().__init__()
        self.adaLN = nn.Linear(hidden_size, 2 * hidden_size, device=device)
        self.linear = nn.Linear(
            hidden_size, patch_size * patch_size * out_channels, device=device
        )

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift, scale = linear(self.adaLN, F.silu(c)).chunk(2, dim=-1)
        return linear(self.linear, modulate(layer_norm_fp32(x), shift, scale))
