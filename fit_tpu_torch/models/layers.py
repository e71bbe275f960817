"""Building blocks of the FiT denoiser as ``nn.Module``s.

Counterpart of ``fit_tpu/models/layers.py`` (dense SwiGLU or tanh-GELU MLP
blocks, attention with RoPE or without it, and the int8 branches of
``quant="int8"``). Parameters may be
stored in another dtype than the compute dtype: every projection casts its
weight to the activation's dtype, which is a no-op once the sampler has cast
the model (``fit_tpu_torch.sampling``). Weights are ``nn.Linear`` (``weight``
is the flax kernel transposed); ``fit_tpu_torch.models.from_jax`` converts a
flax param tree. Under ``quant="int8"`` the projections of
``fit_tpu_torch.ops.quant.QUANT_KERNEL_PATHS`` are ``Int8Linear``s, and the
block feeds them through the fused quant epilogues ``adaln_quant`` and
``silu_mul_quant``.

In a float forward that needs no backward, on the card (:func:`fused_glue`:
sampling, serving, validation), the block's row glue runs in the fused row
kernels of ``fit_tpu_torch.ops.fused_adaln``: each LayerNorm + modulate in
K5, the attention residual with the FFN's LayerNorm + modulate in K5R, and
the SwiGLU product in K6. Training and every CPU forward keep the eager ops.

``plain=True`` in a forward runs every kernel wrapper's plain PyTorch
version on any device (the reference the kernels are held against).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fit_tpu_torch.ops.attention import masked_attention
from fit_tpu_torch.ops.fused_adaln import adaln_modulate, adaln_residual, swiglu_glue
from fit_tpu_torch.ops.quant import Int8Linear, adaln_quant, silu_mul_quant
from fit_tpu_torch.ops.rope_attention import qkv_rope_attention

__all__ = [
    "modulate",
    "layer_norm_fp32",
    "fused_glue",
    "apply_rope",
    "linear",
    "Projection",
    "make_linear",
    "dense",
    "TimestepEmbedder",
    "LabelEmbedder",
    "SwiGLU",
    "GeluMlp",
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


def fused_glue(x: torch.Tensor, quant: str) -> bool:
    """Whether a block's row glue on activation x runs in the fused row
    kernels: a float (``quant="none"``) bf16 or fp32 forward on the card
    that needs no backward, since the kernels have none. A forward under
    grad (training, remat's recompute) and every CPU forward take the eager
    ops, so CPU parity with ``fit_tpu`` stays bit for bit."""
    return (
        quant == "none"
        and x.is_cuda
        and not torch.is_grad_enabled()
        and x.dtype in (torch.bfloat16, torch.float32)
    )


def apply_rope(q: torch.Tensor, k: torch.Tensor, freqs_cis: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """q and k (B, H, T, d) rotated by the interleaved (B, T, d) RoPE table
    (``fit_tpu_torch.core.pos_embed.rope_freqs_2d``), in fp32 and cast back.
    The blocks rotate inside the attention kernel; this is the standalone
    rotation of ``fit_tpu``'s public API."""
    t, d = q.shape[2:]
    fc = freqs_cis.reshape(freqs_cis.shape[0], 1, t, d // 2, 2).float()
    cos, sin = fc[..., 0], fc[..., 1]

    def rot(x):
        xf = x.float().reshape(*x.shape[:3], d // 2, 2)
        a, bb = xf[..., 0], xf[..., 1]
        return torch.stack([a * cos - bb * sin, bb * cos + a * sin], dim=-1).reshape(x.shape).to(x.dtype)

    return rot(q), rot(k)


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)`` computed in x's dtype, whatever the parameters' dtype."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class Projection(nn.Linear):
    """An ``nn.Linear`` (same parameters) that computes in its input's
    dtype: a block's projection. It is called as a module, so forward
    pre-hooks see its input (SmoothQuant calibration,
    ``fit_tpu_torch.ops.equalize``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self, x)


def make_linear(in_features: int, out_features: int, quant: str, device=None) -> nn.Module:
    """A :class:`Projection`, or its int8 counterpart on the quantized path
    (``fit_tpu``'s ``_dense``)."""
    if quant == "int8":
        return Int8Linear(in_features, out_features, device=device)
    return Projection(in_features, out_features, device=device)


def dense(layer: nn.Module, x, dtype: torch.dtype) -> torch.Tensor:
    """A projection's output in ``dtype``: an ``Int8Linear`` takes a float
    activation or a pre-quantized ``(q, scale)`` pair; a
    :class:`Projection` computes in x's dtype, which is ``dtype`` on the
    model's path."""
    if isinstance(layer, Int8Linear):
        return layer(x, dtype)
    return layer(x)


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
    """Class-label embedding; row ``num_classes`` is the CFG null class.

    In training mode each label is dropped to the null class with
    probability ``dropout_prob``, drawn from the ``generator`` the caller
    passes (on the labels' device), as ``fit_tpu`` draws from its explicit
    ``label_dropout`` stream; ``force_drop_ids`` (1 = drop) replaces the draw.
    """

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
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        if force_drop_ids is not None:
            labels = torch.where(force_drop_ids == 1, self.num_classes, labels)
        elif train and self.dropout_prob > 0:
            if generator is None:
                raise ValueError("training-mode label dropout draws from a generator: pass generator=")
            u = torch.rand(labels.shape, generator=generator, device=labels.device)
            labels = torch.where(u < self.dropout_prob, self.num_classes, labels)
        return self.table(labels).to(dtype)


class SwiGLU(nn.Module):
    """Gated FFN ``fc2(silu(fc1_g(x)) * fc1_x(x))``. Under ``quant="int8"``
    the product and its per-row int8 quantization are one fused pass
    (:func:`silu_mul_quant`), whose ``(q, scale)`` feeds fc2; on the
    :func:`fused_glue` route the product is K6 (:func:`swiglu_glue`)."""

    def __init__(self, dim: int, hidden: int, quant: str = "none", device=None):
        super().__init__()
        self.quant = quant
        self.fc1_g = make_linear(dim, hidden, quant, device)
        self.fc1_x = make_linear(dim, hidden, quant, device)
        self.fc2 = make_linear(hidden, dim, quant, device)

    def forward(self, x, dtype: torch.dtype, plain: bool = False) -> torch.Tensor:
        gate = dense(self.fc1_g, x, dtype)
        val = dense(self.fc1_x, x, dtype)
        if self.quant == "int8":
            h = silu_mul_quant(gate, val, plain=plain)
        elif fused_glue(gate, self.quant):
            h = swiglu_glue(gate, val, plain=plain)
        else:
            h = F.silu(gate) * val
        return dense(self.fc2, h, dtype)


class GeluMlp(nn.Module):
    """Plain MLP ``fc2(gelu_tanh(fc1(x)))`` (``fit_tpu``'s ``GeluMlp``, the
    ``ffn="mlp"`` option, DiT's feed-forward)."""

    def __init__(self, dim: int, hidden: int, quant: str = "none", device=None):
        super().__init__()
        self.fc1 = make_linear(dim, hidden, quant, device)
        self.fc2 = make_linear(hidden, dim, quant, device)

    def forward(self, x, dtype: torch.dtype, plain: bool = False) -> torch.Tensor:
        return dense(self.fc2, F.gelu(dense(self.fc1, x, dtype), approximate="tanh"), dtype)


class SelfAttention(nn.Module):
    """Multi-head self-attention with a prefix key mask, with 2D RoPE or
    (``use_rope=False``) without it.

    One flat qkv projection ``(D -> 3D)``. With RoPE its ``[q | k | v]``
    output goes as it is into :func:`qkv_rope_attention`; without, its
    (B, H, T, d) views go into :func:`masked_attention` (``fit_tpu``'s
    non-fused branch), and the (B, H, T, d) result, a view of (B, T, H, d)
    memory, reshapes to (B, T, C) with no copy. Either runs the CUDA kernels
    on the card (the forward, and the backward when training), their plain
    versions on the CPU or with ``plain=True``. Under ``quant="int8"`` qkv
    and proj are ``Int8Linear``s; qkv's (3C, D) weight and (3C,) scale are
    ``fit_tpu``'s grouped (D, 3, C) and (3, C) flattened.
    """

    def __init__(self, dim: int, num_heads: int, quant: str = "none", use_rope: bool = True, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.use_rope = use_rope
        self.qkv = make_linear(dim, 3 * dim, quant, device)
        self.proj = make_linear(dim, dim, quant, device)

    def forward(self, x, cos, sin, lengths, dtype: torch.dtype, plain: bool = False) -> torch.Tensor:
        qkv = dense(self.qkv, x, dtype)
        scale = self.head_dim**-0.5
        if self.use_rope:
            out = qkv_rope_attention(
                qkv, cos, sin, lengths, scale, self.num_heads, check_lengths=False, plain=plain
            )
        else:
            b, t, _ = qkv.shape
            q, k, v = qkv.view(b, t, 3, self.num_heads, self.head_dim).transpose(1, 3).unbind(2)
            out = masked_attention(q, k, v, scale=scale, lengths=lengths, plain=plain)
            out = out.transpose(1, 2).reshape(b, t, -1)
        return dense(self.proj, out, dtype)


class FiTBlock(nn.Module):
    """Pre-LN transformer block with adaLN-Zero conditioning. ``ffn`` is
    "swiglu" (FiT), "mlp" (tanh-GELU, DiT's) or "sparse_moe" (DiT-MoE's
    routed SwiGLU experts at ``mlp_ratio`` width, ``num_experts`` of them,
    ``top_k`` a token, and a shared expert of width ``shared_hidden``:
    ``fit_tpu_torch.models.moe``); ``use_rope=False`` is
    attention without RoPE (DiT, FiT's ``pos_kind="absolute"``), whose
    ``cos``/``sin`` are None. Under ``quant="int8"`` each LayerNorm +
    modulate is fused with the per-row int8 quantization of its result
    (:func:`adaln_quant`), which feeds qkv and fc1. On the
    :func:`fused_glue` route the attention's LayerNorm + modulate is K5, and
    the attention residual with the FFN's LayerNorm + modulate one K5R
    pass; the FFN's residual stays eager."""

    def __init__(
        self,
        hidden_size: int,
        num_heads: int,
        mlp_ratio: float = 4.0,
        quant: str = "none",
        ffn: str = "swiglu",
        use_rope: bool = True,
        device=None,
        num_experts: int = 0,
        top_k: int = 2,
        shared_hidden: int = 0,
    ):
        super().__init__()
        self.quant = quant
        self.adaLN = nn.Linear(hidden_size, 6 * hidden_size, device=device)
        self.attn = SelfAttention(hidden_size, num_heads, quant, use_rope, device=device)
        if ffn == "swiglu":
            self.ffn = SwiGLU(hidden_size, int(hidden_size * mlp_ratio * 2 / 3), quant, device=device)
        elif ffn == "mlp":
            self.ffn = GeluMlp(hidden_size, int(hidden_size * mlp_ratio), quant, device=device)
        elif ffn == "sparse_moe":
            if quant != "none":
                raise ValueError(f"ffn='sparse_moe' has no {quant} path")
            from fit_tpu_torch.models.moe import SparseMoeBlock  # here: moe imports this module

            self.ffn = SparseMoeBlock(hidden_size, int(hidden_size * mlp_ratio), num_experts, top_k, shared_hidden,
                                      device=device)
        elif ffn == "moe":
            raise ValueError("ffn='moe' (fit_tpu's top-1 Switch MoeSwiGLU) is not ported yet (ROADMAP Queue 1, item 9)")
        else:
            raise ValueError(f"unknown ffn {ffn!r}: use 'swiglu', 'mlp' or 'sparse_moe'")

    def _modulated(self, x, shift, scale, plain: bool, fused: bool):
        if self.quant == "int8":
            return adaln_quant(x, shift, scale, plain=plain)
        if fused:
            return adaln_modulate(x, shift, scale, plain=plain)
        return modulate(layer_norm_fp32(x), shift, scale)

    def forward(self, x, c, cos, sin, lengths, plain: bool = False) -> torch.Tensor:
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = linear(
            self.adaLN, F.silu(c)
        ).chunk(6, dim=-1)
        fused = fused_glue(x, self.quant)
        attn_in = self._modulated(x, shift_msa, scale_msa, plain, fused)
        attn_out = self.attn(attn_in, cos, sin, lengths, x.dtype, plain)
        if fused:
            x, ffn_in = adaln_residual(x, attn_out, gate_msa, shift_mlp, scale_mlp, plain=plain)
        else:
            x = x + gate_msa[:, None, :] * attn_out
            ffn_in = self._modulated(x, shift_mlp, scale_mlp, plain, fused)
        return x + gate_mlp[:, None, :] * self.ffn(ffn_in, x.dtype, plain)


class FinalLayer(nn.Module):
    """LayerNorm, 2-way adaLN modulate (K5 on the :func:`fused_glue` route
    of the model's ``quant``), then a projection to patches."""

    def __init__(self, hidden_size: int, patch_size: int, out_channels: int, quant: str = "none", device=None):
        super().__init__()
        self.quant = quant
        self.adaLN = nn.Linear(hidden_size, 2 * hidden_size, device=device)
        self.linear = nn.Linear(
            hidden_size, patch_size * patch_size * out_channels, device=device
        )

    def forward(self, x: torch.Tensor, c: torch.Tensor, plain: bool = False) -> torch.Tensor:
        shift, scale = linear(self.adaLN, F.silu(c)).chunk(2, dim=-1)
        if fused_glue(x, self.quant):
            return linear(self.linear, adaln_modulate(x, shift, scale, plain=plain))
        return linear(self.linear, modulate(layer_norm_fp32(x), shift, scale))
