"""Sampling pipeline: noise -> packed canvas -> guided denoising loop ->
unpadded latents.

Counterpart of ``fit_tpu/sampling.py`` for the DDIM and DDPM samplers. The
canvas, the VisionNTK RoPE tables and the masks are built on the host in
numpy and moved to the device once per call; the denoising loop then runs
on the device with no host round trip.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fit_tpu_torch.core.geometry import pad_latent_to_canvas, token_count, unpad_latent
from fit_tpu_torch.core.pos_embed import rope_freqs_2d
from fit_tpu_torch.diffusion.gaussian import create_diffusion
from fit_tpu_torch.diffusion.samplers import ddim_sample_loop, p_sample_loop
from fit_tpu_torch.models.fit import FiT

__all__ = ["create_pos_embed", "create_mask", "FiTSampler"]


def create_pos_embed(
    h: int,
    w: int,
    patch_size: int,
    max_length: int,
    head_dim: int,
) -> Tuple[np.ndarray, int]:
    """Inference RoPE table for an (h, w) latent, zero-padded to the token
    budget, with VisionNTK on. Returns ``(table (1, T, head_dim) fp32,
    valid_t)``; past the budget the grid is the canvas and T = valid_t."""
    fill = rope_freqs_2d(
        head_dim, h // patch_size, w // patch_size, max_length=max_length
    ).astype(np.float32)
    valid_t = fill.shape[0]
    if valid_t > max_length:
        table = fill
    else:
        table = np.zeros((max_length, head_dim), np.float32)
        table[:valid_t] = fill
    return table[None], valid_t


def create_mask(valid_t: int, max_length: int, n: int) -> np.ndarray:
    """(n, T) prefix validity mask, T = max(valid_t, max_length)."""
    mask = np.zeros((max(valid_t, max_length),), bool)
    mask[:valid_t] = True
    return np.broadcast_to(mask, (n, mask.shape[0])).copy()


class FiTSampler:
    """Class-conditional FiT sampler with classifier-free guidance.

    The model's floating parameters are cast in place to its compute dtype
    (``model.dtype``) and moved to ``device`` once, here; LayerNorm
    statistics stay fp32 inside the blocks. ``sampler`` is "ddim" or "ddpm".
    Sizes are in pixels; latents are ``vae_scale`` times smaller.
    """

    def __init__(
        self,
        model: FiT,
        num_sampling_steps: int = 250,
        cfg_scale: float = 1.5,
        sampler: str = "ddim",
        vae_scale: int = 8,
        max_size: int = 32,
        max_length: int = 256,
        num_classes: int = 1000,
        device=None,
    ):
        if sampler not in ("ddim", "ddpm"):
            raise ValueError(f"unknown sampler {sampler!r}: use 'ddim' or 'ddpm'")
        self.device = torch.device(device) if device is not None else next(model.parameters()).device
        self.model = model.to(device=self.device, dtype=model.dtype)
        self.num_sampling_steps = num_sampling_steps
        self.cfg_scale = cfg_scale
        self.sampler = sampler
        self.vae_scale = vae_scale
        self.max_size = max_size
        self.max_length = max_length
        self.num_classes = num_classes
        self.diffusion = create_diffusion(str(num_sampling_steps))

    def _denoise(self, z, labels, pos, mask, generator) -> torch.Tensor:
        """z: (n, C, h, w) noise; pos/mask for the 2n CFG rows. Returns the
        (n, C, max_size or h, ...) denoised canvas of the conditional half."""
        n = z.shape[0]
        y_all = torch.cat([labels, torch.full_like(labels, self.num_classes)])
        canvas = pad_latent_to_canvas(
            torch.cat([z, z]), self.model.patch_size, self.max_size, self.max_length
        )

        def model_fn(x, t):
            return self.model.forward_with_cfg(x, t, y_all, pos, mask, self.cfg_scale)

        loop = ddim_sample_loop if self.sampler == "ddim" else p_sample_loop
        return loop(self.diffusion, model_fn, canvas, generator, clip_denoised=False)[:n]

    def _noise(self, shape, generator) -> torch.Tensor:
        return torch.randn(shape, generator=generator, device=self.device, dtype=torch.float32)

    @torch.inference_mode()
    def sample(
        self,
        labels: Sequence[int],
        image_height: int = 256,
        image_width: int = 256,
        *,
        generator: Optional[torch.Generator] = None,
        z: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """(n, C, h, w) latents for ``labels`` at one pixel resolution.
        ``z`` (n, C, h, w) replaces the initial noise; otherwise it is drawn
        from ``generator`` (a generator on the sampler's device)."""
        labels = torch.as_tensor(labels, dtype=torch.long, device=self.device)
        n = labels.shape[0]
        p = self.model.patch_size
        h, w = image_height // self.vae_scale, image_width // self.vae_scale
        if z is None:
            z = self._noise((n, self.model.in_channels, h, w), generator)
        z = z.to(self.device, torch.float32)
        pos_np, valid_t = create_pos_embed(h, w, p, self.max_length, self.model.head_dim)
        seq = max(valid_t, self.max_length)
        pos = torch.from_numpy(pos_np).to(self.device).expand(2 * n, seq, -1).contiguous()
        mask = torch.from_numpy(create_mask(valid_t, self.max_length, 2 * n)).to(self.device)
        out = self._denoise(z, labels, pos, mask, generator)
        return unpad_latent(out, valid_t, h, w, p)

    @torch.inference_mode()
    def sample_mixed(
        self,
        labels: Sequence[int],
        sizes: Sequence[Tuple[int, int]],
        *,
        generator: Optional[torch.Generator] = None,
        z: Optional[torch.Tensor] = None,
    ) -> List[torch.Tensor]:
        """One packed denoising run over mixed resolutions: each sample gets
        its own RoPE table and mask on the shared square canvas. ``sizes``
        holds one (height, width) in pixels per label, each within the token
        budget. ``z`` (n, C, max_size, max_size) replaces the canvas noise.
        Returns a list of (C, h_i, w_i) latents."""
        labels = torch.as_tensor(labels, dtype=torch.long, device=self.device)
        n = labels.shape[0]
        if len(sizes) != n:
            raise ValueError(f"{len(sizes)} sizes for {n} labels")
        p = self.model.patch_size
        pos = np.zeros((n, self.max_length, self.model.head_dim), np.float32)
        mask = np.zeros((n, self.max_length), bool)
        valid = []
        for i, (ih, iw) in enumerate(sizes):
            h, w = ih // self.vae_scale, iw // self.vae_scale
            if token_count(h, w, p) > self.max_length:
                raise ValueError(f"size {ih}x{iw} exceeds the token budget; sample() it alone")
            tab, valid_t = create_pos_embed(h, w, p, self.max_length, self.model.head_dim)
            pos[i] = tab[0]
            mask[i, :valid_t] = True
            valid.append((valid_t, h, w))
        shape = (n, self.model.in_channels, self.max_size, self.max_size)
        if z is None:
            z = self._noise(shape, generator)
        elif tuple(z.shape) != shape:
            raise ValueError(f"z {tuple(z.shape)} != {shape}")
        z = z.to(self.device, torch.float32)
        pos2 = torch.from_numpy(np.concatenate([pos, pos])).to(self.device)
        mask2 = torch.from_numpy(np.concatenate([mask, mask])).to(self.device)
        canvas = self._denoise(z, labels, pos2, mask2, generator)
        return [
            unpad_latent(canvas[i : i + 1], vt, h, w, p)[0] for i, (vt, h, w) in enumerate(valid)
        ]
