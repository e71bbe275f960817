"""AutoencoderKL, the Stable-Diffusion VAE (``sd-vae-ft-ema`` / ``-mse``),
as torch ``nn.Module``s in NCHW.

Counterpart of ``fit_tpu/vae/model.py``: block_out_channels (128, 256, 512,
512), 2 resnets per encoder block and 3 per decoder block, GroupNorm(32)
(fewer groups where a small test width has fewer channels), SiLU, a
single-head attention in each mid-block, and a latent of 4 channels at 1/8
of the image size, scaled by 0.18215 (``z = sample(mean, logvar) *
0.18215`` on encode, ``decode(z / 0.18215)``). Module and parameter names
are ``fit_tpu``'s flax names, so both the diffusers converter
(``fit_tpu_torch.vae.convert``) and a flax tree
(``fit_tpu_torch.models.from_jax.torch_vae_state_dict_from_flax``) load.

Dtypes follow ``fit_tpu``: parameters are fp32; each convolution and
linear layer casts its input and weights to the compute ``dtype``;
GroupNorm normalizes in fp32, casts back to its input's dtype and then
applies its fp32 scale and bias, so its output (and the SiLU after it) is
fp32; the attention scores, softmax and probability-weighted sum are fp32.
Convolutions are ``F.conv2d`` (cuDNN on the card) and the attention is
plain ``torch.matmul``: ``fit_tpu`` runs the VAE through XLA, with no
Pallas kernel. The scores are (N, H*W/64, H*W/64) fp32: 4 MiB an image at
256^2, 64 MiB at 512^2, 1 GiB at 1024^2.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fit_tpu_torch.utils.device import resolve_device

__all__ = [
    "SD_VAE_SCALING",
    "GroupNorm",
    "ResnetBlock",
    "AttnBlock",
    "Downsample",
    "Upsample",
    "Encoder",
    "Decoder",
    "DiagonalGaussian",
    "AutoencoderKL",
    "to_uint8",
]

SD_VAE_SCALING = 0.18215


class Conv(nn.Conv2d):
    """``nn.Conv2d`` computing in ``dtype``: input, weight and bias cast."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0, dtype=torch.float32,
                 device=None):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        return F.conv2d(x.to(d), self.weight.to(d), self.bias.to(d), self.stride, self.padding)


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype``: input, weight and bias cast."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32, device=None):
        super().__init__(cin, cout, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        return F.linear(x.to(d), self.weight.to(d), self.bias.to(d))


class GroupNorm(nn.Module):
    """GroupNorm over ``min(groups, channels)`` groups, eps 1e-6: normalized
    in fp32, cast back to the input's dtype, then scaled and shifted by the
    fp32 parameters (so the output is fp32)."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-6, device=None):
        super().__init__()
        self.groups = min(groups, channels)
        if channels % self.groups:
            raise ValueError(f"channels {channels} not divisible by groups {self.groups}")
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.groups, eps=self.eps).to(x.dtype)
        return y * self.weight[:, None, None] + self.bias[:, None, None]


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, dtype=torch.float32, device=None):
        super().__init__()
        self.norm1 = GroupNorm(cin, device=device)
        self.conv1 = Conv(cin, cout, 3, padding=1, dtype=dtype, device=device)
        self.norm2 = GroupNorm(cout, device=device)
        self.conv2 = Conv(cout, cout, 3, padding=1, dtype=dtype, device=device)
        self.shortcut = Conv(cin, cout, 1, dtype=dtype, device=device) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the H*W positions (the mid-blocks)."""

    def __init__(self, channels: int, dtype=torch.float32, device=None):
        super().__init__()
        self.norm = GroupNorm(channels, device=device)
        self.q, self.k, self.v, self.proj_out = (Dense(channels, channels, dtype, device) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        y = self.norm(x).reshape(n, c, h * w).transpose(1, 2)
        q, k, v = self.q(y), self.k(y), self.v(y)
        scores = torch.matmul(q.float(), k.float().transpose(1, 2))
        attn = torch.softmax(scores * c**-0.5, dim=-1).to(y.dtype)
        y = torch.matmul(attn.float(), v.float()).to(y.dtype)
        y = self.proj_out(y)
        return x + y.transpose(1, 2).reshape(n, c, h, w)


class Downsample(nn.Module):
    """Pad (0, 1) on H and W, then a stride-2 3x3 convolution without padding."""

    def __init__(self, channels: int, dtype=torch.float32, device=None):
        super().__init__()
        self.conv = Conv(channels, channels, 3, stride=2, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest-neighbour x2, then a 3x3 convolution."""

    def __init__(self, channels: int, dtype=torch.float32, device=None):
        super().__init__()
        self.conv = Conv(channels, channels, 3, padding=1, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Encoder(nn.Module):
    """(N, 3, H, W) images -> (N, 2 * latent, H/f, W/f) moments, f = 2 per
    block after the first."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512), layers_per_block: int = 2,
                 latent_channels: int = 4, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        top = block_out_channels[-1]
        self.conv_in = Conv(3, block_out_channels[0], 3, padding=1, **kw)
        self.names = []
        prev = block_out_channels[0]
        for i, ch in enumerate(block_out_channels):
            for j in range(layers_per_block):
                self._add(f"down_{i}_block_{j}", ResnetBlock(prev, ch, **kw))
                prev = ch
            if i < len(block_out_channels) - 1:
                self._add(f"down_{i}_downsample", Downsample(ch, **kw))
        self.mid_block_1 = ResnetBlock(top, top, **kw)
        self.mid_attn = AttnBlock(top, **kw)
        self.mid_block_2 = ResnetBlock(top, top, **kw)
        self.norm_out = GroupNorm(top, device=device)
        self.conv_out = Conv(top, 2 * latent_channels, 3, padding=1, **kw)
        self.quant_conv = Conv(2 * latent_channels, 2 * latent_channels, 1, **kw)

    def _add(self, name: str, module: nn.Module) -> None:
        setattr(self, name, module)
        self.names.append(name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for name in self.names:
            x = getattr(self, name)(x)
        x = self.mid_block_2(self.mid_attn(self.mid_block_1(x)))
        x = self.conv_out(F.silu(self.norm_out(x)))
        return self.quant_conv(x)


class Decoder(nn.Module):
    """(N, latent, h, w) unscaled latents -> (N, 3, h*f, w*f) images."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512), layers_per_block: int = 3,
                 latent_channels: int = 4, out_channels: int = 3, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        rev = list(reversed(block_out_channels))
        self.post_quant_conv = Conv(latent_channels, latent_channels, 1, **kw)
        self.conv_in = Conv(latent_channels, rev[0], 3, padding=1, **kw)
        self.mid_block_1 = ResnetBlock(rev[0], rev[0], **kw)
        self.mid_attn = AttnBlock(rev[0], **kw)
        self.mid_block_2 = ResnetBlock(rev[0], rev[0], **kw)
        self.names = []
        prev = rev[0]
        for i, ch in enumerate(rev):
            for j in range(layers_per_block):
                self._add(f"up_{i}_block_{j}", ResnetBlock(prev, ch, **kw))
                prev = ch
            if i < len(rev) - 1:
                self._add(f"up_{i}_upsample", Upsample(ch, **kw))
        self.norm_out = GroupNorm(rev[-1], device=device)
        self.conv_out = Conv(rev[-1], out_channels, 3, padding=1, **kw)

    _add = Encoder._add

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(self.post_quant_conv(z))
        x = self.mid_block_2(self.mid_attn(self.mid_block_1(x)))
        for name in self.names:
            x = getattr(self, name)(x)
        return self.conv_out(F.silu(self.norm_out(x)))


class DiagonalGaussian:
    """The latent distribution of (N, 2 * latent, h, w) moments: mean and
    log variance split on axis 1, the log variance clipped to [-30, 20]."""

    def __init__(self, moments: torch.Tensor):
        self.mean, logvar = moments.chunk(2, dim=1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None):
        """mean + std * noise; ``noise`` is drawn from ``generator`` (on the
        moments' device, in their dtype) unless given."""
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator, device=self.mean.device, dtype=self.mean.dtype)
        return self.mean + self.std * noise.to(self.mean.device, self.mean.dtype)

    def mode(self) -> torch.Tensor:
        return self.mean


class AutoencoderKL(nn.Module):
    """The SD VAE on ``device`` (the card unless the caller names another),
    computing in ``dtype``. Images are (N, 3, H, W) in [-1, 1]; latents are
    (N, latent, H/8, W/8) (with 4 blocks), scaled by 0.18215. Inputs are
    moved to the module's device.

    * ``encode_moments(images)``: the (N, 2 * latent, H/8, W/8) moments
      (``fit_tpu`` returns them NHWC);
    * ``encode(images, generator=, noise=)``: a draw of the posterior,
      scaled;
    * ``encode_mode(images)``: its mean, scaled;
    * ``decode(latents)``: the images of scaled latents.

    Parameters come from PyTorch's default init (a checkpoint replaces
    them: ``fit_tpu_torch.vae.convert``).
    """

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512), latent_channels: int = 4,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.block_out_channels = tuple(block_out_channels)
        self.latent_channels = latent_channels
        self.dtype = dtype
        self.encoder = Encoder(block_out_channels, latent_channels=latent_channels, dtype=dtype, device=device)
        self.decoder = Decoder(block_out_channels, latent_channels=latent_channels, dtype=dtype, device=device)

    @property
    def device(self) -> torch.device:
        return self.decoder.conv_in.weight.device

    def encode_moments(self, images: torch.Tensor) -> torch.Tensor:
        return self.encoder(images.to(self.device))

    def encode(self, images: torch.Tensor, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        z = DiagonalGaussian(self.encode_moments(images)).sample(generator, noise)
        return z * SD_VAE_SCALING

    def encode_mode(self, images: torch.Tensor) -> torch.Tensor:
        return DiagonalGaussian(self.encode_moments(images)).mode() * SD_VAE_SCALING

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        return self.decoder(latents.to(self.device) / SD_VAE_SCALING)

    def forward(self, images: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The round trip, decode(encode(images))."""
        return self.decode(self.encode(images, generator))


def to_uint8(images) -> np.ndarray:
    """(..., 3, H, W) images in [-1, 1] (a tensor or an array, any float
    dtype) -> (..., H, W, 3) uint8 on the host, as ``fit_tpu`` writes PNGs:
    clipped in fp32, scaled by 255 and truncated."""
    if isinstance(images, torch.Tensor):
        images = images.detach().float().cpu().numpy()
    img = np.clip((np.asarray(images, np.float32) + 1) / 2, 0, 1)
    return (np.moveaxis(img, -3, -1) * 255).astype(np.uint8)
