"""ADM's Gaussian diffusion as the reference samples and trains with it.

The linear schedule (betas 1e-4 to 0.02 over 1000 steps), respaced to
``n`` steps by ADM's ``space_timesteps`` (evenly strided, Python's
``round``); DDIM at eta 0 and DPM-Solver++(2M) (Lu et al.,
arXiv:2211.01095) in its data-prediction form, whose last step returns its
x0; and the forward process ``q_sample``. Coefficients are float64, the
state fp32.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

STEPS = 1000


def alphas_cumprod() -> np.ndarray:
    betas = np.linspace(1e-4, 0.02, STEPS, dtype=np.float64)
    return np.cumprod(1.0 - betas)


def respaced(n: int) -> List[int]:
    """The kept timesteps of ``space_timesteps(1000, str(n))``, ascending."""
    if n == STEPS:
        return list(range(STEPS))
    stride = (STEPS - 1) / (n - 1)
    return sorted({round(i * stride) for i in range(n)})


def ddim(eps_fn: Callable, x: torch.Tensor, steps: int) -> torch.Tensor:
    """Deterministic DDIM from noise ``x``; ``eps_fn(x, t)`` takes the base
    process's timestep."""
    kept = respaced(steps)
    ac = alphas_cumprod()[kept]
    for i in range(len(kept) - 1, -1, -1):
        ab, ab_prev = ac[i], (ac[i - 1] if i > 0 else 1.0)
        t = torch.full((x.shape[0],), kept[i], dtype=torch.long, device=x.device)
        eps = eps_fn(x, t)
        x0 = float(np.sqrt(1.0 / ab)) * x - float(np.sqrt(1.0 / ab - 1.0)) * eps
        eps = (float(np.sqrt(1.0 / ab)) * x - x0) / float(np.sqrt(1.0 / ab - 1.0))
        x = x0 * float(np.sqrt(ab_prev)) + float(np.sqrt(1.0 - ab_prev)) * eps
    return x


def dpm_solver_pp_2m(eps_fn: Callable, x: torch.Tensor, steps: int) -> torch.Tensor:
    """DPM-Solver++(2M) from noise ``x`` over the respaced steps: first
    order on the first step, the last step's x0 as the sample."""
    kept = respaced(steps)
    ac = alphas_cumprod()[kept]
    alpha, sigma = np.sqrt(ac), np.sqrt(1.0 - ac)
    lam = 0.5 * (np.log(ac) - np.log(1.0 - ac))
    x0_prev = None
    for s in range(len(kept) - 1, -1, -1):
        t = torch.full((x.shape[0],), kept[s], dtype=torch.long, device=x.device)
        x0 = (x - float(sigma[s]) * eps_fn(x, t)) / float(alpha[s])
        if s == 0:
            return x0
        h = lam[s - 1] - lam[s]
        if x0_prev is None:
            d = x0
        else:
            r = (lam[s] - lam[s + 1]) / h  # the previous step's h over this one's
            d = (1.0 + 1.0 / (2.0 * r)) * x0 - (1.0 / (2.0 * r)) * x0_prev
        x = float(sigma[s - 1] / sigma[s]) * x - float(alpha[s - 1] * np.expm1(-h)) * d
        x0_prev = x0
    return x


def q_sample(x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    ac = alphas_cumprod()
    a = torch.from_numpy(np.sqrt(ac).astype(np.float32)).to(x0.device)[t]
    b = torch.from_numpy(np.sqrt(1.0 - ac).astype(np.float32)).to(x0.device)[t]
    shape = (-1,) + (1,) * (x0.dim() - 1)
    return a.reshape(shape) * x0 + b.reshape(shape) * noise
