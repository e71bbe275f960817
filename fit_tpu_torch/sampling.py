"""Sampling pipeline: noise -> packed canvas -> guided denoising loop ->
unpadded latents.

Counterpart of ``fit_tpu/sampling.py`` for the DDIM, DDPM and DPM-Solver++
(2M) samplers. The canvas, the VisionNTK RoPE tables and the masks are
built on the host in numpy, the masks are checked there and turned into
prefix lengths, and all of it moves to the device once per call (from
pinned memory, without waiting for the device); the denoising loop then
runs on the device with no host round trip, so a caller can enqueue the
next batch while one computes (``fit_tpu_torch.serve``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fit_tpu_torch.core.geometry import pad_latent_to_canvas, token_count, unpad_latent
from fit_tpu_torch.core.pos_embed import rope_freqs_2d, sincos_2d
from fit_tpu_torch.diffusion.dpm_solver import dpm_solver_pp_2m
from fit_tpu_torch.diffusion.gaussian import create_diffusion
from fit_tpu_torch.diffusion.samplers import ddim_sample_loop, p_sample_loop
from fit_tpu_torch.models.fit import FiT
from fit_tpu_torch.utils.device import resolve_device

__all__ = ["create_pos_embed", "create_mask", "mask_lengths", "cast_for_sampling", "FiTSampler"]


def create_pos_embed(
    h: int,
    w: int,
    patch_size: int,
    max_length: int,
    embed_dim: int,
    method: str = "rotate",
) -> Tuple[np.ndarray, int]:
    """Inference pos table for an (h, w) latent, zero-padded to the token
    budget: the RoPE table with VisionNTK on (``method="rotate"``,
    ``embed_dim`` the head dim) or the 2D sincos table (``"absolute"``,
    ``embed_dim`` the hidden size). Returns ``(table (1, T, embed_dim) fp32,
    valid_t)``; past the budget the grid is the canvas and T = valid_t."""
    nh, nw = h // patch_size, w // patch_size
    if method == "rotate":
        fill = rope_freqs_2d(embed_dim, nh, nw, max_length=max_length)
    elif method == "absolute":
        fill = sincos_2d(embed_dim, nh, nw)
    else:
        raise ValueError(f"unknown method {method!r}: use 'rotate' or 'absolute'")
    fill = fill.astype(np.float32)
    valid_t = fill.shape[0]
    if valid_t > max_length:
        table = fill
    else:
        table = np.zeros((max_length, embed_dim), np.float32)
        table[:valid_t] = fill
    return table[None], valid_t


def create_mask(valid_t: int, max_length: int, n: int) -> np.ndarray:
    """(n, T) prefix validity mask, T = max(valid_t, max_length)."""
    mask = np.zeros((max(valid_t, max_length),), bool)
    mask[:valid_t] = True
    return np.broadcast_to(mask, (n, mask.shape[0])).copy()


def mask_lengths(mask: np.ndarray) -> np.ndarray:
    """(n, T) host prefix mask -> (n,) int32 lengths; raises if a row has no
    valid token (its softmax would be empty)."""
    lengths = mask.sum(axis=-1).astype(np.int32)
    if (lengths < 1).any():
        raise ValueError("every mask row needs at least one valid token")
    return lengths


def cast_for_sampling(model: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """Move ``model`` (a ``FiT`` or a ``DiT``) to ``device`` and cast, in place, its floating
    parameters and buffers to the compute dtype ``model.dtype``, as
    ``fit_tpu``'s ``_cast_params`` does: int8 weights stay int8 and every
    ``kernel_scale`` stays fp32 (``nn.Module.to(dtype=)`` would cast them),
    as does each parameter a module names in its ``fp32_params``."""
    model.to(device=device)
    for module in model.modules():
        keep = getattr(module, "fp32_params", ())  # e.g. a sparse-MoE router
        for name, p in module.named_parameters(recurse=False):
            if p.is_floating_point() and name != "kernel_scale" and name not in keep:
                p.data = p.data.to(model.dtype)
        for name, b in module.named_buffers(recurse=False):
            if b.is_floating_point() and name != "kernel_scale":
                module._buffers[name] = b.to(model.dtype)
    return model


class FiTSampler:
    """Class-conditional FiT sampler with classifier-free guidance.

    The model's floating parameters are cast in place to its compute dtype
    (``model.dtype``, except int8 scales: :func:`cast_for_sampling`) and
    moved to ``device`` once, here; LayerNorm statistics stay fp32 inside
    the blocks. ``device`` is the card unless the caller names another
    (``"cpu"``); without a card that raises. ``sampler`` is "ddim", "ddpm"
    or "dpm" (DPM-Solver++ (2M)); "ddim" and "dpm" are deterministic given
    the initial noise.
    Sizes are in pixels; latents are ``vae_scale`` times smaller. The model
    is a FiT with ``pos_kind="rotate"``, as in ``fit_tpu``; a DiT samples
    through ``fit_tpu_torch.diffusion.samplers`` with its
    ``forward_with_cfg`` (``fit_tpu_torch.models.dit``).
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
        device="cuda",
    ):
        if sampler not in ("ddim", "ddpm", "dpm"):
            raise ValueError(f"unknown sampler {sampler!r}: use 'ddim', 'ddpm' or 'dpm'")
        if not isinstance(model, FiT) or model.pos_kind != "rotate":
            raise ValueError("FiTSampler samples a FiT with pos_kind='rotate'")
        self.device = resolve_device(device)
        self.model = cast_for_sampling(model, self.device)
        self.num_sampling_steps = num_sampling_steps
        self.cfg_scale = cfg_scale
        self.sampler = sampler
        self.vae_scale = vae_scale
        self.max_size = max_size
        self.max_length = max_length
        self.num_classes = num_classes
        self.diffusion = create_diffusion(str(num_sampling_steps))

    def _to_device(self, x, dtype=None) -> torch.Tensor:
        """A host array or tensor on the sampler's device. From the host to a
        card it goes through pinned memory without waiting for the device,
        so it does not wait for work already enqueued."""
        x = torch.as_tensor(x)
        if x.device == self.device:
            return x.to(dtype=dtype)
        if self.device.type == "cuda" and x.device.type == "cpu":
            x = x.pin_memory()
        return x.to(self.device, dtype=dtype, non_blocking=True)

    def _denoise(self, z, labels, pos, lengths, generator) -> torch.Tensor:
        """z: (n, C, h, w) noise; pos/lengths for the 2n CFG rows. Returns the
        (n, C, max_size or h, ...) denoised canvas of the conditional half."""
        n = z.shape[0]
        y_all = torch.cat([labels, torch.full_like(labels, self.num_classes)])
        canvas = pad_latent_to_canvas(
            torch.cat([z, z]), self.model.patch_size, self.max_size, self.max_length
        )

        def model_fn(x, t):
            return self.model.forward_with_cfg(x, t, y_all, pos, None, self.cfg_scale, lengths=lengths)

        if self.sampler == "dpm":
            return dpm_solver_pp_2m(self.diffusion, model_fn, canvas, clip_denoised=False)[:n]
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
        labels = self._to_device(torch.as_tensor(labels), torch.long)
        n = labels.shape[0]
        p = self.model.patch_size
        h, w = image_height // self.vae_scale, image_width // self.vae_scale
        valid_t = token_count(h, w, p)
        lengths = mask_lengths(create_mask(valid_t, self.max_length, 2 * n))
        pos_np, _ = create_pos_embed(h, w, p, self.max_length, self.model.head_dim)
        if z is None:
            z = self._noise((n, self.model.in_channels, h, w), generator)
        z = self._to_device(z, torch.float32)
        seq = max(valid_t, self.max_length)
        pos = self._to_device(pos_np).expand(2 * n, seq, -1).contiguous()
        out = self._denoise(z, labels, pos, self._to_device(lengths), generator)
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
        labels = self._to_device(torch.as_tensor(labels), torch.long)
        n = labels.shape[0]
        if len(sizes) != n:
            raise ValueError(f"{len(sizes)} sizes for {n} labels")
        p = self.model.patch_size
        pos = np.zeros((n, self.max_length, self.model.head_dim), np.float32)
        mask = np.zeros((n, self.max_length), bool)
        valid = []
        for i, (ih, iw) in enumerate(sizes):
            h, w = ih // self.vae_scale, iw // self.vae_scale
            valid_t = token_count(h, w, p)
            if valid_t > self.max_length:
                raise ValueError(f"size {ih}x{iw} exceeds the token budget; sample() it alone")
            mask[i, :valid_t] = True
            valid.append((valid_t, h, w))
        lengths = mask_lengths(np.concatenate([mask, mask]))
        for i, (_, h, w) in enumerate(valid):
            pos[i] = create_pos_embed(h, w, p, self.max_length, self.model.head_dim)[0][0]
        shape = (n, self.model.in_channels, self.max_size, self.max_size)
        if z is None:
            z = self._noise(shape, generator)
        elif tuple(z.shape) != shape:
            raise ValueError(f"z {tuple(z.shape)} != {shape}")
        z = self._to_device(z, torch.float32)
        pos2 = self._to_device(np.concatenate([pos, pos]))
        canvas = self._denoise(z, labels, pos2, self._to_device(lengths), generator)
        return [
            unpad_latent(canvas[i : i + 1], vt, h, w, p)[0] for i, (vt, h, w) in enumerate(valid)
        ]
