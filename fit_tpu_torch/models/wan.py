"""Wan2.1 text-to-video (Wan-AI, github.com/Wan-Video/Wan2.1): a
rectified-flow transformer over the tokens of a video latent, with
cross-attention to umT5 text states.

The released ``wan/modules/model.py`` with its parameter names and
``nn.Linear`` layouts (``WanModel``, ``WanAttentionBlock``, ``Head``):

* ``patch_embedding``: a Conv3d with kernel and stride (1, 2, 2) over the
  (16, F, H, W) latent, computed as the Linear over each patch's 64 values
  that it is (channel slowest); tokens in (frame, row, column) order.
* ``text_embedding`` (Linear, tanh GELU, Linear) of the 512 umT5 rows of
  each prompt, padding rows included; ``time_embedding`` (Linear, SiLU,
  Linear) of the ``[cos | sin]`` features of t (float64), and
  ``time_projection`` (SiLU, Linear to 6D) once a forward for all blocks.
* ``WanAttentionBlock``: ``m = modulation + e0`` (six (B, D) chunks), then
  ``x += self_attn(LN(x)(1 + m1) + m0) m2``, ``x += cross_attn(norm3(x),
  context)`` and ``x += ffn(LN(x)(1 + m4) + m3) m5``. LN is affine-free,
  ``norm3`` a LayerNorm with weight and bias, eps 1e-6. Self-attention: q,
  k, v and o Linears with bias, ``WanRMSNorm`` of q and of k over all D
  lanes (across heads) with a (D,) weight, 3-axis RoPE on interleaved
  pairs (head dim split 44 / 42 / 42 between frames, rows and columns,
  ``rope_ids_nd``), full attention. Cross-attention: q from x, k and v
  from the text rows, the same RMSNorms, no RoPE.
* ``Head``: ``(modulation + e)`` as (shift, scale) around an affine-free
  LN, then ``Linear(D, 64)`` per token, unpatchified channel fastest.

The residual stream, the modulation, the time embedding and the head stay
in fp32 as the released code keeps them under its fp32 autocast regions;
every other matmul runs in the compute dtype (``dtype``), whose casts of
fp32 weights autocast's per-call casts equal. The time embedding, time
projection, modulations and head are kept in fp32 by
``fit_tpu_torch.sampling.cast_for_sampling`` (``fp32_params``).

In a float forward without grad on the card (``layers.fused_glue``) a
block's row glue runs in the hand-written kernels: LN + modulate of the
fp32 stream into a bf16 row in K5, the gated self-attention residual with
``norm3`` (a column-constant shift and scale) in K5R, the cross-attention
residual with the FFN's LN + modulate in K5R (gate 1), each QK-RMSNorm in
K8W (``ops.fused_adaln.qk_norm_wide``, in place), the GELU in K6G, the
self-attention in K1 (``ops.rope_attention.rope_flash_attention``) and the
cross-attention in K1's key loop over the text rows
(``ops.rope_attention.cross_attention``). Every other forward (the CPU,
under grad) runs the released composition in eager ops, through the
attention wrappers' plain versions on the CPU; ``plain_kernels`` routes
every kernel wrapper to its plain version on any device. The FFN's
residual ``x + m5 y`` stays eager on both routes. Each block call records
a ``wan.self_attn`` and a ``wan.cross_attn`` span; each forward counts its
video tokens (``wan.video_tokens``) and text keys (``wan.text_keys``).

``create_wan("wan2.1-t2v-14b")`` holds the released t2v-14B sizes
(14,288,491,584 parameters); sampling is
``fit_tpu_torch.diffusion.flow.denoise_guided``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fit_tpu_torch.core.pos_embed import rope_ids_nd
from fit_tpu_torch.models.layers import fused_glue, layer_norm_fp32, linear, modulate
from fit_tpu_torch.ops.fused_adaln import adaln_modulate, adaln_residual, gelu_glue, qk_norm_wide
from fit_tpu_torch.ops.rope_attention import cross_attention, rope_flash_attention, split_rope_tables
from fit_tpu_torch.utils import profiling
from fit_tpu_torch.utils.device import resolve_device

__all__ = ["WanModel", "WanAttentionBlock", "create_wan", "patchify", "unpatchify", "sinusoidal_embedding_1d",
           "rope_axes"]


def sinusoidal_embedding_1d(dim: int, position: torch.Tensor) -> torch.Tensor:
    """``[cos | sin]`` of ``position * 10000**(-j / (dim / 2))`` in float64,
    as the released code computes it (the caller casts to fp32)."""
    half = dim // 2
    position = position.to(torch.float64)
    freqs = torch.pow(10000, -torch.arange(half, dtype=torch.float64, device=position.device).div(half))
    sinusoid = torch.outer(position, freqs)
    return torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=1)


def rope_axes(head_dim: int) -> Tuple[int, int, int]:
    """The head dim's split between frames, rows and columns:
    ``(d - 4 (d // 6), 2 (d // 6), 2 (d // 6))``, (44, 42, 42) at 128."""
    third = 2 * (head_dim // 6)
    return head_dim - 2 * third, third, third


def patchify(x: torch.Tensor, patch: Sequence[int] = (1, 2, 2)) -> torch.Tensor:
    """(B, C, F, H, W) -> (B, f h w, C pf ph pw) tokens in (frame, row,
    column) order, each patch's values channel slowest (the Conv3d
    weight's order)."""
    b, c, f, h, w = x.shape
    pf, ph, pw = patch
    x = x.reshape(b, c, f // pf, pf, h // ph, ph, w // pw, pw)
    return x.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(b, (f // pf) * (h // ph) * (w // pw), c * pf * ph * pw)


def unpatchify(x: torch.Tensor, grid: Sequence[int], patch: Sequence[int] = (1, 2, 2)) -> torch.Tensor:
    """(B, f h w, pf ph pw C) head outputs, channel fastest (the released
    ``einsum('fhwpqrc->cfphqwr')``) -> (B, C, f pf, h ph, w pw)."""
    b = x.shape[0]
    f, h, w = grid
    pf, ph, pw = patch
    c = x.shape[-1] // (pf * ph * pw)
    x = x.reshape(b, f, h, w, pf, ph, pw, c).permute(0, 7, 1, 4, 2, 5, 3, 6)
    return x.reshape(b, c, f * pf, h * ph, w * pw)


class WanRMSNorm(nn.Module):
    """RMSNorm over the whole row (all heads): fp32 statistics, cast to x's
    dtype, then times ``weight``."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        normed = (xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps)).to(x.dtype)
        return normed * self.weight.to(x.dtype)


class WanLayerNorm(nn.Module):
    """``norm3``: a LayerNorm with weight and bias, in fp32."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), x.shape[-1:], self.weight.float(), self.bias.float(), self.eps)


class WanAttention(nn.Module):
    """q, k, v and o Linears with bias and the RMSNorms of q and k; the
    self-attention's (``self_attn``) and the cross-attention's
    (``cross_attn``, keys and values from the text rows)."""

    def __init__(self, dim: int, num_heads: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.num_heads = num_heads
        for name in ("q", "k", "v", "o"):
            setattr(self, name, nn.Linear(dim, dim, device=device))
        self.norm_q = WanRMSNorm(dim, eps, device=device)
        self.norm_k = WanRMSNorm(dim, eps, device=device)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        return x.view(*x.shape[:2], self.num_heads, -1)

    def qkv(self, x: torch.Tensor, src: torch.Tensor, fused: bool, plain: bool):
        """q of ``x``, k and v of ``src``, each (B, T, H, d), q and k normed
        (K8W in place on the fused route)."""
        q, k, v = linear(self.q, x), linear(self.k, src), linear(self.v, src)
        if fused:
            qk_norm_wide(q, self.norm_q.weight, eps=self.norm_q.eps, plain=plain)
            qk_norm_wide(k, self.norm_k.weight, eps=self.norm_k.eps, plain=plain)
        else:
            q, k = self.norm_q(q), self.norm_k(k)
        return self._heads(q), self._heads(k), self._heads(v)

    def out(self, o: torch.Tensor) -> torch.Tensor:
        return linear(self.o, o.reshape(*o.shape[:2], -1))


class WanAttentionBlock(nn.Module):
    """Self-attention with 3-axis RoPE, cross-attention to the text rows and
    a tanh-GELU FFN around an fp32 residual stream, modulated by
    ``modulation + e0``."""

    def __init__(self, dim: int, ffn_dim: int, num_heads: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.dim, self.num_heads, self.eps = dim, num_heads, eps
        self.self_attn = WanAttention(dim, num_heads, eps, device=device)
        self.norm3 = WanLayerNorm(dim, eps, device=device)
        self.cross_attn = WanAttention(dim, num_heads, eps, device=device)
        self.ffn = nn.Sequential(nn.Linear(dim, ffn_dim, device=device), nn.GELU(approximate="tanh"),
                                 nn.Linear(ffn_dim, dim, device=device))
        self.modulation = nn.Parameter(torch.randn(1, 6, dim, device=device) / dim**0.5)
        self.fp32_params = ("modulation",)

    def _conditioning(self, m: torch.Tensor) -> torch.Tensor:
        """(B, 9, D) fp32 rows the row kernels read at one row stride: the
        six modulation chunks, ``norm3`` as a shift (bias) and scale (weight
        - 1), and a gate of ones."""
        b, _, d = m.shape
        w3 = self.norm3.weight.float()
        extra = torch.stack((self.norm3.bias.float(), w3 - 1, torch.ones_like(w3)))
        return torch.cat((m, extra[None].expand(b, 3, d)), dim=1)

    def forward(self, x, e0, cos, sin, lengths, ctx, ctx_lengths, plain: bool = False):
        """x (B, L, D) fp32 after the block; e0 (B, 6, D) fp32; cos and sin
        (B, L, d) fp32 tables; lengths (B,) int32 (every row whole); ctx
        (B, L_txt, D) text rows in the compute dtype; ctx_lengths (B,) int32
        text keys attended."""
        dt = ctx.dtype
        m = self.modulation.float() + e0
        scale = (self.dim // self.num_heads) ** -0.5
        fused = fused_glue(ctx, "none")
        sa, ca = self.self_attn, self.cross_attn
        if fused:
            cond = self._conditioning(m)
            with profiling.span("wan.self_attn"):
                h = adaln_modulate(x, cond[:, 0], cond[:, 1], eps=self.eps, out_dtype=dt, plain=plain)
                q, k, v = sa.qkv(h, h, True, plain)
                y = sa.out(rope_flash_attention(q, k, v, cos, sin, lengths, scale, plain=plain))
            with profiling.span("wan.cross_attn"):
                x, h = adaln_residual(x, y, cond[:, 2], cond[:, 6], cond[:, 7], eps=self.eps, out_dtype=dt,
                                      plain=plain)
                q, k, v = ca.qkv(h, ctx, True, plain)
                y = ca.out(cross_attention(q, k, v, ctx_lengths, scale, plain=plain))
            x, h = adaln_residual(x, y, cond[:, 8], cond[:, 3], cond[:, 4], eps=self.eps, out_dtype=dt, plain=plain)
            y = linear(self.ffn[2], gelu_glue(linear(self.ffn[0], h), plain=plain))
            return x.addcmul_(y, cond[:, 5, None])
        with profiling.span("wan.self_attn"):
            h = modulate(layer_norm_fp32(x, self.eps), m[:, 0], m[:, 1]).to(dt)
            q, k, v = sa.qkv(h, h, False, plain)
            y = sa.out(rope_flash_attention(q, k, v, cos, sin, lengths, scale, plain=plain))
        with profiling.span("wan.cross_attn"):
            x = x + y * m[:, 2, None]
            q, k, v = ca.qkv(self.norm3(x).to(dt), ctx, False, plain)
            y = ca.out(cross_attention(q, k, v, ctx_lengths, scale, plain=plain))
        x = x + y
        h = modulate(layer_norm_fp32(x, self.eps), m[:, 3], m[:, 4]).to(dt)
        y = linear(self.ffn[2], F.gelu(linear(self.ffn[0], h), approximate="tanh"))
        return x + y * m[:, 5, None]


class Head(nn.Module):
    """``(modulation + e)`` as (shift, scale) around an affine-free LN, then
    ``head`` to ``prod(patch) * out_dim`` per token, all in fp32."""

    def __init__(self, dim: int, out_dim: int, patch: Sequence[int], eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.head = nn.Linear(dim, out_dim * patch[0] * patch[1] * patch[2], device=device)
        self.head.fp32_params = ("weight", "bias")
        self.modulation = nn.Parameter(torch.randn(1, 2, dim, device=device) / dim**0.5)
        self.fp32_params = ("modulation",)

    def forward(self, x: torch.Tensor, e: torch.Tensor, plain: bool = False) -> torch.Tensor:
        n = self.modulation.float() + e[:, None]
        shift, scale = n[:, 0], n[:, 1]
        if fused_glue(x, "none"):
            h = adaln_modulate(x, shift, scale, eps=self.eps, plain=plain)
        else:
            h = modulate(layer_norm_fp32(x, self.eps), shift, scale)
        return linear(self.head, h)


def _fp32_linear(*args, **kwargs) -> nn.Linear:
    layer = nn.Linear(*args, **kwargs)
    layer.fp32_params = ("weight", "bias")
    return layer


class WanModel(nn.Module):
    """``forward(x, t, context, context_lens=None)``: the velocity (B, C, F,
    H, W) fp32 of latents ``x`` (B, C, F, H, W) at timesteps ``t`` (B,) in
    [0, 1000], with text rows ``context`` (B, text_len, text_dim) (umT5
    states zero-padded to ``text_len``). ``context_lens`` (B,) limits the
    text keys each row attends; None, as the released t2v sampler passes,
    attends all ``text_len`` rows."""

    def __init__(
        self,
        patch_size: Sequence[int] = (1, 2, 2),
        text_len: int = 512,
        in_dim: int = 16,
        dim: int = 5120,
        ffn_dim: int = 13824,
        freq_dim: int = 256,
        text_dim: int = 4096,
        out_dim: int = 16,
        num_heads: int = 40,
        num_layers: int = 40,
        eps: float = 1e-6,
        theta: float = 10000.0,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        if dim % num_heads or (dim // num_heads) % 2:
            raise ValueError(f"dim {dim} must split into {num_heads} heads of an even width")
        self.patch_size = tuple(patch_size)
        self.text_len, self.dim, self.num_heads, self.freq_dim = text_len, dim, num_heads, freq_dim
        self.theta = theta
        self.dtype = dtype
        self.plain_kernels = False
        self.patch_embedding = nn.Conv3d(in_dim, dim, kernel_size=self.patch_size, stride=self.patch_size,
                                         device=device)
        self.text_embedding = nn.Sequential(nn.Linear(text_dim, dim, device=device), nn.GELU(approximate="tanh"),
                                            nn.Linear(dim, dim, device=device))
        self.time_embedding = nn.Sequential(_fp32_linear(freq_dim, dim, device=device), nn.SiLU(),
                                            _fp32_linear(dim, dim, device=device))
        self.time_projection = nn.Sequential(nn.SiLU(), _fp32_linear(dim, 6 * dim, device=device))
        self.blocks = nn.ModuleList(
            WanAttentionBlock(dim, ffn_dim, num_heads, eps, device=device) for _ in range(num_layers))
        self.head = Head(dim, out_dim, self.patch_size, eps, device=device)

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    def rope_tables(self, batch: int, grid: Sequence[int], device) -> Tuple[torch.Tensor, torch.Tensor]:
        """K1's pair-duplicated (B, f h w, d) fp32 cos and sin of the video
        tokens, from their (frame, row, column) ids."""
        f, h, w = grid
        axes = [torch.arange(n, device=device, dtype=torch.float32) for n in (f, h, w)]
        ids = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(1, f * h * w, 3)
        return split_rope_tables(rope_ids_nd(ids.expand(batch, -1, -1), rope_axes(self.head_dim), self.theta))

    def forward(self, x, t, context, context_lens=None) -> torch.Tensor:
        dt, plain = self.dtype, self.plain_kernels
        b = x.shape[0]
        grid = [n // p for n, p in zip(x.shape[2:], self.patch_size)]
        pe = self.patch_embedding
        tokens = F.linear(patchify(x.to(dt), self.patch_size), pe.weight.to(dt).reshape(self.dim, -1),
                          pe.bias.to(dt)).float()
        e = self.time_embedding(sinusoidal_embedding_1d(self.freq_dim, t).float())
        e0 = self.time_projection(e).unflatten(1, (6, self.dim))
        te = self.text_embedding
        ctx = linear(te[2], F.gelu(linear(te[0], context.to(dt)), approximate="tanh"))
        cos, sin = self.rope_tables(b, grid, x.device)
        lengths = torch.full((b,), tokens.shape[1], dtype=torch.int32, device=x.device)
        if context_lens is None:
            ctx_lengths = torch.full((b,), ctx.shape[1], dtype=torch.int32, device=x.device)
        else:
            ctx_lengths = torch.as_tensor(context_lens, device=x.device).to(torch.int32)
        profiling.count("wan.video_tokens", b * tokens.shape[1])
        profiling.count("wan.text_keys", b * ctx.shape[1])
        for block in self.blocks:
            tokens = block(tokens, e0, cos, sin, lengths, ctx, ctx_lengths, plain)
        return unpatchify(self.head(tokens, e, plain), grid, self.patch_size)


# the released configurations' sizes (wan/configs/wan_t2v_14B.py)
_SIZES = {
    "wan2.1-t2v-14b": dict(patch_size=(1, 2, 2), text_len=512, in_dim=16, dim=5120, ffn_dim=13824, freq_dim=256,
                           text_dim=4096, out_dim=16, num_heads=40, num_layers=40, eps=1e-6),
}


def create_wan(name: str, device="cuda", **kwargs) -> WanModel:
    """A Wan model by registry name, e.g. ``create_wan("wan2.1-t2v-14b",
    dtype=torch.bfloat16, device="meta")``, built on the card unless
    ``device`` names another."""
    if name not in _SIZES:
        raise KeyError(f"no Wan model named {name!r}: the registry has {sorted(_SIZES)}")
    return WanModel(**{**_SIZES[name], **kwargs}, device=resolve_device(device))
