"""DDPM ancestral and DDIM sampling loops.

Counterpart of ``fit_tpu/diffusion/samplers.py``: the ``lax.scan`` over
timesteps becomes a Python loop. Per-step noise is ``step_noise[i]`` for
timestep ``i`` (indexed by timestep value, not loop order) when injected,
else drawn from ``generator``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from fit_tpu_torch.diffusion.gaussian import GaussianDiffusion

__all__ = ["p_sample_loop", "ddim_sample_loop"]


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
    step_noise: Optional[torch.Tensor] = None,
    return_trajectory: bool = False,
) -> torch.Tensor:
    """DDPM ancestral sampling from ``x_T`` down to ``x_0``. ``model_fn(x, t)``
    is bound to its conditioning; respaced timesteps are remapped here.
    ``return_trajectory`` stacks every step's sample, last step last."""
    wrapped = diffusion.wrap_model(model_fn)

    def step(x, t, i):
        noise = _noise_for_step(generator, step_noise, i, x)
        return diffusion.p_sample(wrapped, x, t, noise, clip_denoised)["sample"]

    return _loop(step, diffusion, x_T, return_trajectory)


def ddim_sample_loop(
    diffusion: GaussianDiffusion,
    model_fn: Callable,
    x_T: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    clip_denoised: bool = True,
    eta: float = 0.0,
    step_noise: Optional[torch.Tensor] = None,
    return_trajectory: bool = False,
) -> torch.Tensor:
    """DDIM sampling; deterministic at ``eta=0`` (the default)."""
    wrapped = diffusion.wrap_model(model_fn)

    def step(x, t, i):
        noise = None if eta == 0.0 else _noise_for_step(generator, step_noise, i, x)
        return diffusion.ddim_sample(wrapped, x, t, noise, clip_denoised, eta)["sample"]

    return _loop(step, diffusion, x_T, return_trajectory)
