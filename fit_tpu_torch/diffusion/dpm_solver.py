"""DPM-Solver++ (2M): deterministic fast sampling in tens of steps.

Counterpart of ``fit_tpu/diffusion/dpm_solver.py``: the second-order
multistep solver in the data-prediction (x0) form (Lu et al., DPM-Solver++,
arXiv:2211.01095) on the discrete schedule, as a Python loop over the
respaced steps. At step i with cumulative product ``abar_i``:
``alpha_i = sqrt(abar_i)``, ``sigma_i = sqrt(1 - abar_i)`` and the half
log-SNR ``lam_i = 0.5 * log(abar_i / (1 - abar_i))``. From step s to step
t, with ``h = lam_t - lam_s``:

  1st order:  x_t = (sigma_t / sigma_s) x_s - alpha_t (e^{-h} - 1) x0(x_s)
  2M:         x0 replaced by (1 + 1/(2r)) x0_s - 1/(2r) x0_prev,
              r = h_prev / h.

The first step is first order; the last (from step 0) returns its x0. The
per-step scalars are ``fit_tpu``'s: fp32 tables taken from the fp64
``alphas_cumprod``, combined in fp32 (``expm1``) on the host.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from fit_tpu_torch.diffusion.gaussian import GaussianDiffusion

__all__ = ["dpm_solver_pp_2m"]


def dpm_solver_pp_2m(
    diffusion: GaussianDiffusion,
    model_fn: Callable,
    x_T: torch.Tensor,
    *,
    clip_denoised: bool = False,
) -> torch.Tensor:
    """Sample with DPM-Solver++(2M) over the diffusion's (respaced) steps.

    ``model_fn(x, t)`` is bound to its conditioning and takes the base
    process's timesteps; a respaced process remaps them here. Its output
    is eps, or x0 when ``diffusion.predict_xstart``; with more channels than
    ``x_T`` (``learn_sigma``) the first ``C`` are used."""
    wrapped = diffusion.wrap_model(model_fn)
    abar = diffusion.c.alphas_cumprod  # fp64, ascending in t
    alpha = np.sqrt(abar).astype(np.float32)
    sigma = np.sqrt(1.0 - abar).astype(np.float32)
    lam = (0.5 * (np.log(abar) - np.log(1.0 - abar))).astype(np.float32)
    one, two = np.float32(1.0), np.float32(2.0)

    def predict_x0(x, i):
        t = torch.full((x.shape[0],), i, dtype=torch.long, device=x.device)
        out = wrapped(x, t)[:, : x.shape[1]]
        x0 = out if diffusion.predict_xstart else (x - float(sigma[i]) * out) / float(alpha[i])
        return x0.clamp(-1, 1) if clip_denoised else x0

    x, x0_prev, lam_prev = x_T, None, None
    for s in range(diffusion.num_timesteps - 1, -1, -1):
        x0_s = predict_x0(x, s)
        if s == 0:  # the last step does not move: its x0 is the sample
            return x0_s
        t = s - 1
        h = lam[t] - lam[s]
        phi = np.expm1(-h)  # e^{-h} - 1
        if x0_prev is None:  # first order on the first step
            d = x0_s
        else:
            half_inv_r = one / (two * ((lam[s] - lam_prev) / h))
            d = float(one + half_inv_r) * x0_s - float(half_inv_r) * x0_prev
        x = float(sigma[t] / sigma[s]) * x - float(alpha[t] * phi) * d
        x0_prev, lam_prev = x0_s, lam[s]
    return x
