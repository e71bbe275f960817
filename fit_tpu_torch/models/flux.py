"""FLUX.1 (Black Forest Labs, github.com/black-forest-labs/flux): a
rectified-flow transformer over two token streams, text and image.

The released ``src/flux/model.py`` and ``modules/layers.py`` with their
parameter names and ``nn.Linear`` layouts:

* ``img_in`` embeds the packed latent (16 channels in 2 x 2 patches: 64 a
  token, ``fit_tpu_torch.diffusion.flow.pack``), ``txt_in`` the T5 states,
  ``time_in`` the ``[cos | sin]`` features of ``1000 t`` and ``vector_in``
  the pooled CLIP vector, the last two summed into ``vec``.
* ``DoubleStreamBlock``: each stream has its own modulation (shift, scale
  and gate, twice, from ``silu(vec)``), affine-free LayerNorms (eps 1e-6),
  qkv (with bias), QK-RMSNorm, proj and tanh-GELU MLP; the two streams meet
  in one attention over ``[txt | img]`` with no mask.
* ``SingleStreamBlock`` on ``[txt | img]``: one modulation (shift, scale,
  gate), ``linear1`` to ``[q | k | v | m]``, attention beside ``gelu(m)``,
  and ``linear2`` of ``[attn | gelu(m)]`` into a gated residual.
* ``LastLayer``: adaLN (shift, scale), then a projection of the image rows
  back to 64 channels.

Positions are FLUX's N-axis RoPE (``EmbedND``) from per-token ids, text
rows at (0, 0, 0) and image rows at (0, row, col)
(``fit_tpu_torch.core.pos_embed.rope_ids_nd``), rotating q and k inside
the attention kernel after the QK-RMSNorm.

In a float forward without grad on the card (``layers.fused_glue``), a
block's row glue runs in the hand-written kernels: each LayerNorm +
modulate in K5, the attention residual with norm2 + modulate in K5R, the
QK-RMSNorm in K8 (``ops.fused_adaln.qk_norm``), the GELU in K6G
(``gelu_glue``) and the attention in K1 (``ops.rope_attention``). A double
block's K8 writes both streams' normed q, k and v into one joint (B, T,
3D) buffer, at row offsets 0 and ``T_txt``: that pass is the
concatenation. A single block's K8 norms q and k in place in linear1's
output, K1 writes its output into columns 0..D of linear2's input and K6G
``gelu(m)`` into the columns after them, so no concatenation is copied.
Every other forward (the CPU, under grad) runs the released composition
in eager ops, through the attention wrappers' plain versions on the CPU;
``plain_kernels`` routes every kernel wrapper to its plain version on any
device. The residual ``x + gate * y`` stays eager on both routes.

``dtype`` is the compute dtype; parameters are created in fp32 and
``fit_tpu_torch.sampling.cast_for_sampling`` casts them once.
``create_flux("flux-schnell")`` holds the released sizes (11,891,178,560
parameters); sampling is ``fit_tpu_torch.diffusion.flow.denoise``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fit_tpu_torch.core.pos_embed import rope_ids_nd
from fit_tpu_torch.models.layers import TimestepEmbedder, fused_glue, layer_norm_fp32, linear, modulate
from fit_tpu_torch.ops.fused_adaln import adaln_modulate, adaln_residual, gelu_glue, qk_norm
from fit_tpu_torch.ops.rope_attention import rope_flash_attention, split_rope_tables
from fit_tpu_torch.utils import profiling
from fit_tpu_torch.utils.device import resolve_device

__all__ = [
    "Flux",
    "DoubleStreamBlock",
    "SingleStreamBlock",
    "MLPEmbedder",
    "LastLayer",
    "create_flux",
]


class MLPEmbedder(nn.Module):
    """``out_layer(silu(in_layer(x)))``, computed in x's dtype."""

    def __init__(self, in_dim: int, hidden_dim: int, device=None):
        super().__init__()
        self.in_layer = nn.Linear(in_dim, hidden_dim, device=device)
        self.out_layer = nn.Linear(hidden_dim, hidden_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self.out_layer, F.silu(linear(self.in_layer, x)))


class RMSNorm(nn.Module):
    """FLUX's RMSNorm of the last dim: fp32 statistics, the result cast to
    x's dtype, then times the learned ``scale``."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        rrms = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + 1e-6)
        return (xf * rrms).to(x.dtype) * self.scale.to(x.dtype)


class QKNorm(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.query_norm = RMSNorm(dim, device=device)
        self.key_norm = RMSNorm(dim, device=device)

    def forward(self, q: torch.Tensor, k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.query_norm(q), self.key_norm(k)

    @property
    def scales(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.query_norm.scale, self.key_norm.scale


class Modulation(nn.Module):
    """``lin(silu(vec))`` in 6 (double) or 3 (single) (B, D) chunks: shift,
    scale and gate, once or twice."""

    def __init__(self, dim: int, double: bool, device=None):
        super().__init__()
        self.multiplier = 6 if double else 3
        self.lin = nn.Linear(dim, self.multiplier * dim, device=device)

    def forward(self, vec: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return linear(self.lin, F.silu(vec)).chunk(self.multiplier, dim=-1)


class SelfAttention(nn.Module):
    """A stream's qkv, QK-RMSNorm and proj (FLUX's ``SelfAttention``; the
    attention itself is the block's, over both streams)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias, device=device)
        self.norm = QKNorm(dim // num_heads, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def heads(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The eager route's normed q, k and v, each (B, T, H, d)."""
        b, t, d = x.shape
        q, k, v = linear(self.qkv, x).view(b, t, 3, self.num_heads, d // self.num_heads).unbind(2)
        q, k = self.norm(q, k)
        return q, k, v


def _mlp(seq: nn.Sequential, x: torch.Tensor, plain: bool, fused: bool) -> torch.Tensor:
    """``Linear, GELU(tanh), Linear`` of an ``nn.Sequential``, the GELU in
    K6G on the fused route."""
    h = linear(seq[0], x)
    h = gelu_glue(h, plain=plain) if fused else F.gelu(h, approximate="tanh")
    return linear(seq[2], h)


class DoubleStreamBlock(nn.Module):
    """Text and image streams, each with its own weights, joined in one
    attention over ``[txt | img]``."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float, qkv_bias: bool = False, device=None):
        super().__init__()
        mlp_hidden = int(hidden_size * mlp_ratio)
        self.num_heads = num_heads
        for s in ("img", "txt"):
            setattr(self, f"{s}_mod", Modulation(hidden_size, double=True, device=device))
            setattr(self, f"{s}_attn", SelfAttention(hidden_size, num_heads, qkv_bias, device=device))
            setattr(self, f"{s}_mlp", nn.Sequential(
                nn.Linear(hidden_size, mlp_hidden, device=device),
                nn.GELU(approximate="tanh"),
                nn.Linear(mlp_hidden, hidden_size, device=device),
            ))

    def forward(self, img, txt, vec, cos, sin, lengths, plain: bool = False):
        """(img, txt) after the block; cos and sin (B, T_txt + T_img, d) fp32
        tables of the joint rows, lengths (B,) int32 (every row whole)."""
        with profiling.span("flux.double"):
            fused = fused_glue(img, "none")
            img_mod, txt_mod = self.img_mod(vec), self.txt_mod(vec)
            b, tt, d = txt.shape
            t = tt + img.shape[1]
            h, scale = self.num_heads, (d // self.num_heads) ** -0.5
            if fused:
                joint = img.new_empty((b, t, 3 * d))
                for x, attn, (shift, sc, *_), row in ((txt, self.txt_attn, txt_mod, 0), (img, self.img_attn, img_mod, tt)):
                    qkv = linear(attn.qkv, adaln_modulate(x, shift, sc, plain=plain))
                    qk_norm(qkv, *attn.norm.scales, h, out=joint, row_offset=row, plain=plain)
                q, k, v = joint.view(b, t, 3, h, d // h).unbind(2)
            else:
                parts = [self.txt_attn.heads(modulate(layer_norm_fp32(txt), *txt_mod[:2])),
                         self.img_attn.heads(modulate(layer_norm_fp32(img), *img_mod[:2]))]
                q, k, v = (torch.cat(pair, dim=1) for pair in zip(*parts))
            out = rope_flash_attention(q, k, v, cos, sin, lengths, scale, plain=plain).reshape(b, t, d)
            txt = self._stream(txt, out[:, :tt], self.txt_attn, self.txt_mlp, txt_mod, plain, fused)
            img = self._stream(img, out[:, tt:], self.img_attn, self.img_mlp, img_mod, plain, fused)
        return img, txt

    @staticmethod
    def _stream(x, attn_out, attn, mlp, mod, plain: bool, fused: bool):
        """One stream's attention residual and its MLP's."""
        _, _, gate1, shift2, scale2, gate2 = mod
        y = linear(attn.proj, attn_out)
        if fused:
            x, h = adaln_residual(x, y, gate1, shift2, scale2, plain=plain)
        else:
            x = x + gate1[:, None, :] * y
            h = modulate(layer_norm_fp32(x), shift2, scale2)
        return x + gate2[:, None, :] * _mlp(mlp, h, plain, fused)


class SingleStreamBlock(nn.Module):
    """One stream of ``[txt | img]`` rows: attention and MLP in parallel
    from one ``linear1``, into one ``linear2``."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.mlp_hidden = int(hidden_size * mlp_ratio)
        self.linear1 = nn.Linear(hidden_size, 3 * hidden_size + self.mlp_hidden, device=device)
        self.linear2 = nn.Linear(hidden_size + self.mlp_hidden, hidden_size, device=device)
        self.norm = QKNorm(hidden_size // num_heads, device=device)
        self.modulation = Modulation(hidden_size, double=False, device=device)

    def forward(self, x, vec, cos, sin, lengths, plain: bool = False):
        with profiling.span("flux.single"):
            shift, scale, gate = self.modulation(vec)
            b, t, d = x.shape
            h, hd = self.num_heads, d // self.num_heads
            if fused_glue(x, "none"):
                h1 = linear(self.linear1, adaln_modulate(x, shift, scale, plain=plain))
                qk_norm(h1, *self.norm.scales, h, plain=plain)
                q, k, v = h1[..., : 3 * d].view(b, t, 3, h, hd).unbind(2)
                cat = x.new_empty((b, t, d + self.mlp_hidden))  # linear2's input [attn | gelu(m)]
                rope_flash_attention(q, k, v, cos, sin, lengths, hd**-0.5, out=cat[..., :d].view(b, t, h, hd),
                                     plain=plain)
                gelu_glue(h1[..., 3 * d :], out=cat[..., d:], plain=plain)
            else:
                qkv, m = linear(self.linear1, modulate(layer_norm_fp32(x), shift, scale)).split(
                    [3 * d, self.mlp_hidden], dim=-1)
                q, k, v = qkv.reshape(b, t, 3, h, hd).unbind(2)
                q, k = self.norm(q, k)
                attn = rope_flash_attention(q, k, v, cos, sin, lengths, hd**-0.5, plain=plain).reshape(b, t, d)
                cat = torch.cat((attn, F.gelu(m, approximate="tanh")), dim=2)
            out = x + gate[:, None, :] * linear(self.linear2, cat)
        return out


class LastLayer(nn.Module):
    """adaLN (shift, scale) of ``silu(vec)`` around an affine-free
    LayerNorm, then the projection to ``patch * patch * out_channels``."""

    def __init__(self, hidden_size: int, patch_size: int, out_channels: int, device=None):
        super().__init__()
        self.linear = nn.Linear(hidden_size, patch_size * patch_size * out_channels, device=device)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(hidden_size, 2 * hidden_size, device=device))

    def forward(self, x: torch.Tensor, vec: torch.Tensor, plain: bool = False) -> torch.Tensor:
        shift, scale = linear(self.adaLN_modulation[1], F.silu(vec)).chunk(2, dim=-1)
        if fused_glue(x, "none"):
            return linear(self.linear, adaln_modulate(x.contiguous(), shift, scale, plain=plain))
        return linear(self.linear, modulate(layer_norm_fp32(x), shift, scale))


class Flux(nn.Module):
    """``forward(img, img_ids, txt, txt_ids, timesteps, y)``: the velocity
    (B, T_img, in_channels) of packed latents ``img`` (B, T_img,
    in_channels) at ``timesteps`` (B,) in [0, 1], with T5 states ``txt`` (B,
    T_txt, context_in_dim), the pooled vector ``y`` (B, vec_in_dim) and
    (B, T, len(axes_dim)) position ids of each stream. The output is in the
    compute dtype."""

    def __init__(
        self,
        in_channels: int = 64,
        vec_in_dim: int = 768,
        context_in_dim: int = 4096,
        hidden_size: int = 3072,
        mlp_ratio: float = 4.0,
        num_heads: int = 24,
        depth: int = 19,
        depth_single_blocks: int = 38,
        axes_dim: Sequence[int] = (16, 56, 56),
        theta: float = 10000.0,
        qkv_bias: bool = True,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        if hidden_size % num_heads or sum(axes_dim) != hidden_size // num_heads:
            raise ValueError(f"axes_dim {tuple(axes_dim)} must sum to the head dim {hidden_size // num_heads}")
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.axes_dim = tuple(axes_dim)
        self.theta = theta
        self.dtype = dtype
        self.plain_kernels = False
        self.img_in = nn.Linear(in_channels, hidden_size, device=device)
        self.time_in = MLPEmbedder(256, hidden_size, device=device)
        self.vector_in = MLPEmbedder(vec_in_dim, hidden_size, device=device)
        self.txt_in = nn.Linear(context_in_dim, hidden_size, device=device)
        self.double_blocks = nn.ModuleList(
            DoubleStreamBlock(hidden_size, num_heads, mlp_ratio, qkv_bias, device=device) for _ in range(depth))
        self.single_blocks = nn.ModuleList(
            SingleStreamBlock(hidden_size, num_heads, mlp_ratio, device=device) for _ in range(depth_single_blocks))
        self.final_layer = LastLayer(hidden_size, 1, in_channels, device=device)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def rope_tables(self, txt_ids: torch.Tensor, img_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """K1's pair-duplicated (B, T, d) fp32 cos and sin of the joint
        ``[txt | img]`` rows."""
        ids = torch.cat((txt_ids, img_ids), dim=1)
        return split_rope_tables(rope_ids_nd(ids, self.axes_dim, self.theta))

    def forward(self, img, img_ids, txt, txt_ids, timesteps, y) -> torch.Tensor:
        dt, plain = self.dtype, self.plain_kernels
        img = linear(self.img_in, img.to(dt))
        vec = self.time_in(TimestepEmbedder.timestep_embedding(1000.0 * timesteps.float(), 256).to(dt))
        vec = vec + self.vector_in(y.to(dt))
        txt = linear(self.txt_in, txt.to(dt))
        cos, sin = self.rope_tables(txt_ids, img_ids)
        b, tt = txt.shape[:2]
        lengths = torch.full((b,), tt + img.shape[1], dtype=torch.int32, device=img.device)
        for block in self.double_blocks:
            img, txt = block(img, txt, vec, cos, sin, lengths, plain)
        x = torch.cat((txt, img), dim=1)
        for block in self.single_blocks:
            x = block(x, vec, cos, sin, lengths, plain)
        return self.final_layer(x[:, tt:], vec, plain)


# the released configurations' sizes (src/flux/util.py); schnell has no
# guidance embedding
_SIZES = {
    "flux-schnell": dict(in_channels=64, vec_in_dim=768, context_in_dim=4096, hidden_size=3072, mlp_ratio=4.0,
                         num_heads=24, depth=19, depth_single_blocks=38, axes_dim=(16, 56, 56), theta=10000.0,
                         qkv_bias=True),
}


def create_flux(name: str, device="cuda", **kwargs) -> Flux:
    """A FLUX model by registry name, e.g. ``create_flux("flux-schnell",
    dtype=torch.bfloat16, device="meta")``, built on the card unless
    ``device`` names another."""
    if name not in _SIZES:
        raise KeyError(f"no FLUX model named {name!r}: the registry has {sorted(_SIZES)}")
    return Flux(**{**_SIZES[name], **kwargs}, device=resolve_device(device))

