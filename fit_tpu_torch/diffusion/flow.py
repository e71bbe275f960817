"""Rectified-flow sampling for FLUX (``src/flux/sampling.py`` of
github.com/black-forest-labs/flux): the time schedule, the Euler loop and
the 2 x 2 packing of latents into tokens; and for Wan2.1
(github.com/Wan-Video/Wan2.1 ``wan/text2video.py``): the shifted schedule
and an Euler loop with classifier-free guidance.

The model predicts a velocity ``v(x, t)``; from noise at t = 1 the loop
steps ``x += (t_next - t) * v(x, t)`` down to t = 0. FLUX.1-schnell takes 4
steps on the unshifted schedule 1, .75, .5, .25, 0 and no guidance, so one
forward row an image. The loop keeps ``x`` in the dtype it is given (the
caller's noise, fp32 here) and casts each prediction to it before the
step; the released command line keeps it in bf16.

Wan's t2v sampler shifts the times as ``shift t / (1 + (shift - 1) t)``
(``shift`` 5.0 for t2v-14B), which is :func:`time_shift` at ``mu = ln
shift``, and guides each step: ``v = v_uncond + guide_scale (v_cond -
v_uncond)``. :func:`denoise_guided` takes both evaluations as one batch of
``[cond | uncond]`` rows (the released code makes two batch-1 calls, with
the same arithmetic a row) and steps with Euler where the release uses
UniPC: every solver spends one guided pair of evaluations a step.
"""

from __future__ import annotations

import math
from typing import List

import torch

__all__ = ["get_schedule", "shifted_schedule", "time_shift", "denoise", "denoise_guided", "pack", "unpack",
           "img_ids", "txt_ids"]


def time_shift(mu: float, sigma: float, t: torch.Tensor) -> torch.Tensor:
    return math.exp(mu) / (math.exp(mu) + (1 / t - 1) ** sigma)


def get_schedule(num_steps: int, image_seq_len: int, base_shift: float = 0.5, max_shift: float = 1.15,
                 shift: bool = True) -> List[float]:
    """The ``num_steps + 1`` times from 1 to 0: evenly spaced, or with
    ``shift`` moved towards 1 by ``mu``, linear in the image's token count
    (0.5 at 256 tokens, 1.15 at 4096), as FLUX.1-dev samples."""
    timesteps = torch.linspace(1, 0, num_steps + 1)
    if shift:
        mu = base_shift + (max_shift - base_shift) / (4096 - 256) * (image_seq_len - 256)
        timesteps = time_shift(mu, 1.0, timesteps)
    return timesteps.tolist()


def shifted_schedule(num_steps: int, shift: float) -> List[float]:
    """The ``num_steps + 1`` times from 1 to 0, evenly spaced and then
    shifted as ``shift t / (1 + (shift - 1) t)`` (Wan's ``sample_shift``)."""
    return time_shift(math.log(shift), 1.0, torch.linspace(1, 0, num_steps + 1, dtype=torch.float64)).tolist()


@torch.inference_mode()
def denoise_guided(model, z: torch.Tensor, context: torch.Tensor, context_null: torch.Tensor,
                   timesteps: List[float], guide_scale: float) -> torch.Tensor:
    """Euler steps over ``timesteps`` with classifier-free guidance from
    noise ``z`` (B, C, F, H, W); ``model`` is a ``WanModel`` (``model(x,
    t, context)``, t = 1000 times the time). Each step runs one batch of 2B
    rows, the prompt's ``context`` then the negative prompt's
    ``context_null`` (each (B, text_len, text_dim)), every text row
    attended as the released t2v sampler does, and keeps z in its own
    dtype. Returns the latents at the last time."""
    n = z.shape[0]
    ctx = torch.cat((context, context_null))
    for t_curr, t_prev in zip(timesteps[:-1], timesteps[1:]):
        t_vec = torch.full((2 * n,), 1000.0 * t_curr, dtype=torch.float32, device=z.device)
        cond, uncond = model(torch.cat((z, z)), t_vec, ctx).to(z.dtype).chunk(2)
        z = z + (t_prev - t_curr) * (uncond + guide_scale * (cond - uncond))
    return z


@torch.inference_mode()
def denoise(model, img: torch.Tensor, img_ids: torch.Tensor, txt: torch.Tensor, txt_ids: torch.Tensor,
            vec: torch.Tensor, timesteps: List[float]) -> torch.Tensor:
    """The Euler loop over ``timesteps`` from packed noise ``img`` (B, T_img,
    C); ``model`` is a ``Flux`` (``model(img=, img_ids=, txt=, txt_ids=,
    y=, timesteps=)``). Returns the packed latents at the last time."""
    for t_curr, t_prev in zip(timesteps[:-1], timesteps[1:]):
        t_vec = torch.full((img.shape[0],), t_curr, dtype=img.dtype, device=img.device)
        pred = model(img=img, img_ids=img_ids, txt=txt, txt_ids=txt_ids, y=vec, timesteps=t_vec)
        img = img + (t_prev - t_curr) * pred.to(img.dtype)
    return img


def pack(z: torch.Tensor) -> torch.Tensor:
    """(B, C, h, w) latents -> (B, (h/2)(w/2), 4C) tokens, each a 2 x 2
    patch with the channel slowest (``b c (h 2) (w 2) -> b (h w) (c 2 2)``)."""
    b, c, h, w = z.shape
    return z.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5).reshape(b, (h // 2) * (w // 2), 4 * c)


def unpack(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The inverse of :func:`pack` for an (h, w) latent."""
    b, _, c4 = x.shape
    return x.reshape(b, h // 2, w // 2, c4 // 4, 2, 2).permute(0, 3, 1, 4, 2, 5).reshape(b, c4 // 4, h, w)


def img_ids(batch: int, h: int, w: int, device=None) -> torch.Tensor:
    """(B, (h/2)(w/2), 3) fp32 ids of an (h, w) latent's tokens: (0, row,
    col) on the 2 x 2 patch grid, row-major."""
    ids = torch.zeros(h // 2, w // 2, 3, device=device)
    ids[..., 1] = torch.arange(h // 2, device=device)[:, None]
    ids[..., 2] = torch.arange(w // 2, device=device)[None, :]
    return ids.reshape(1, -1, 3).expand(batch, -1, -1)


def txt_ids(batch: int, length: int, device=None) -> torch.Tensor:
    """(B, length, 3) zero ids of the text tokens."""
    return torch.zeros(batch, length, 3, device=device)
