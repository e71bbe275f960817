"""DDPM ancestral, DDIM and reverse-DDIM sampling loops, and a CFG wrapper.

Counterpart of ``fit_tpu/diffusion/samplers.py``: the ``lax.scan`` over
timesteps becomes a Python loop. Per-step noise is ``step_noise[i]`` for
timestep ``i`` (indexed by timestep value, not loop order) when injected,
else drawn from ``generator``. ``denoised_fn`` and ``cond_fn`` are the
hooks of :meth:`GaussianDiffusion.p_mean_variance` and of guidance.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from fit_tpu_torch.diffusion.gaussian import GaussianDiffusion

__all__ = ["p_sample_loop", "ddim_sample_loop", "ddim_reverse_loop", "cfg_model_fn"]


def _noise_for_step(
    generator: Optional[torch.Generator],
    step_noise: Optional[torch.Tensor],
    i: int,
    x: torch.Tensor,
) -> torch.Tensor:
    if step_noise is not None:
        return step_noise[i]
    return torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)


def _loop(step, diffusion: GaussianDiffusion, x_T: torch.Tensor, return_trajectory: bool):
    x = x_T
    traj = []
    for i in range(diffusion.num_timesteps - 1, -1, -1):
        t = torch.full((x.shape[0],), i, dtype=torch.long, device=x.device)
        x = step(x, t, i)
        if return_trajectory:
            traj.append(x)
    return torch.stack(traj) if return_trajectory else x


def p_sample_loop(
    diffusion: GaussianDiffusion,
    model_fn: Callable,
    x_T: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    clip_denoised: bool = True,
    denoised_fn=None,
    cond_fn=None,
    step_noise: Optional[torch.Tensor] = None,
    return_trajectory: bool = False,
) -> torch.Tensor:
    """DDPM ancestral sampling from ``x_T`` down to ``x_0``. ``model_fn(x, t)``
    is bound to its conditioning; respaced timesteps are remapped here.
    ``return_trajectory`` stacks every step's sample, last step last."""
    wrapped = diffusion.wrap_model(model_fn)

    def step(x, t, i):
        noise = _noise_for_step(generator, step_noise, i, x)
        return diffusion.p_sample(wrapped, x, t, noise, clip_denoised, denoised_fn, cond_fn)["sample"]

    return _loop(step, diffusion, x_T, return_trajectory)


def ddim_sample_loop(
    diffusion: GaussianDiffusion,
    model_fn: Callable,
    x_T: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    clip_denoised: bool = True,
    denoised_fn=None,
    cond_fn=None,
    eta: float = 0.0,
    step_noise: Optional[torch.Tensor] = None,
    return_trajectory: bool = False,
) -> torch.Tensor:
    """DDIM sampling; deterministic at ``eta=0`` (the default)."""
    wrapped = diffusion.wrap_model(model_fn)

    def step(x, t, i):
        noise = None if eta == 0.0 else _noise_for_step(generator, step_noise, i, x)
        return diffusion.ddim_sample(wrapped, x, t, noise, clip_denoised, denoised_fn, cond_fn, eta)["sample"]

    return _loop(step, diffusion, x_T, return_trajectory)


def ddim_reverse_loop(
    diffusion: GaussianDiffusion,
    model_fn: Callable,
    x_0: torch.Tensor,
    *,
    clip_denoised: bool = False,
    denoised_fn=None,
) -> torch.Tensor:
    """The DDIM reverse ODE (encoding): deterministic x_0 -> x_T over
    ascending t, the inverse of ``ddim_sample_loop`` at eta=0."""
    wrapped = diffusion.wrap_model(model_fn)
    x = x_0
    for i in range(diffusion.num_timesteps):
        t = torch.full((x.shape[0],), i, dtype=torch.long, device=x.device)
        x = diffusion.ddim_reverse_sample(wrapped, x, t, clip_denoised, denoised_fn)["sample"]
    return x


def cfg_model_fn(apply_fn: Callable, cfg_scale: float, in_channels: int = 4) -> Callable:
    """A plain conditional ``apply_fn(x, t)`` in the classifier-free-guidance
    protocol of ``FiT.forward_with_cfg``: the batch is packed as
    [conditional | unconditional] halves with the same latents, and the
    guided eps (the first ``in_channels``) comes back in both halves, the
    other channels as the model gave them. For models without a CFG
    forward of their own."""

    def wrapped(x, t):
        half = x[: x.shape[0] // 2]
        out = apply_fn(torch.cat([half, half], dim=0), t)
        eps, rest = out[:, :in_channels], out[:, in_channels:]
        cond_eps, uncond_eps = eps.chunk(2, dim=0)
        guided = uncond_eps + cfg_scale * (cond_eps - uncond_eps)
        return torch.cat([torch.cat([guided, guided], dim=0), rest], dim=1)

    return wrapped
