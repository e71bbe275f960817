"""Noise schedules and diffusion coefficient tables, float64 numpy.

Counterpart of ``fit_tpu/core/schedules.py``: the beta schedule shapes
("quad", "linear", "warmup10", "warmup50", "const", "jsd") and the named
schedules built on them, the per-timestep coefficient tables and timestep
respacing. Same arithmetic in the same order, so every table is byte-equal
to ``fit_tpu``'s. Samplers index a table, then round the value to float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Union

import numpy as np

__all__ = [
    "beta_schedule",
    "betas_from_alpha_bar",
    "named_beta_schedule",
    "DiffusionCoefficients",
    "compute_coefficients",
    "space_timesteps",
    "respaced_betas",
]


def _warmup_betas(beta_start: float, beta_end: float, n: int, frac: float) -> np.ndarray:
    betas = beta_end * np.ones(n, dtype=np.float64)
    warmup = int(n * frac)
    betas[:warmup] = np.linspace(beta_start, beta_end, warmup, dtype=np.float64)
    return betas


def beta_schedule(name: str, *, beta_start: float, beta_end: float, num_steps: int) -> np.ndarray:
    """The schedule shapes: "quad", "linear", "warmup10", "warmup50",
    "const" or "jsd" (1/T, 1/(T-1), ..., 1)."""
    if name == "quad":
        return np.linspace(beta_start**0.5, beta_end**0.5, num_steps, dtype=np.float64) ** 2
    if name == "linear":
        return np.linspace(beta_start, beta_end, num_steps, dtype=np.float64)
    if name == "warmup10":
        return _warmup_betas(beta_start, beta_end, num_steps, 0.1)
    if name == "warmup50":
        return _warmup_betas(beta_start, beta_end, num_steps, 0.5)
    if name == "const":
        return beta_end * np.ones(num_steps, dtype=np.float64)
    if name == "jsd":
        return 1.0 / np.linspace(num_steps, 1, num_steps, dtype=np.float64)
    raise ValueError(f"unknown beta schedule shape: {name}")


def betas_from_alpha_bar(num_steps: int, alpha_bar, max_beta: float = 0.999) -> np.ndarray:
    """Betas that discretize a continuous alpha-bar function of t in [0, 1]."""
    betas = []
    for i in range(num_steps):
        t1 = i / num_steps
        t2 = (i + 1) / num_steps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas)


def named_beta_schedule(name: str, num_steps: int) -> np.ndarray:
    """"linear" (betas 1e-4..0.02 at 1000 steps, rescaled for other counts)
    or "squaredcos_cap_v2"."""
    if name == "linear":
        scale = 1000 / num_steps
        return beta_schedule("linear", beta_start=scale * 0.0001, beta_end=scale * 0.02, num_steps=num_steps)
    if name == "squaredcos_cap_v2":
        return betas_from_alpha_bar(
            num_steps, lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
        )
    raise ValueError(f"unknown beta schedule: {name}")


@dataclasses.dataclass(frozen=True)
class DiffusionCoefficients:
    """Every per-timestep coefficient table of the q/p math, float64 ``(T,)``."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    alphas_cumprod_next: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    # FIXED_LARGE: beta_t with the t=0 slot replaced by the t=1 posterior variance
    fixed_large_variance: np.ndarray
    fixed_large_log_variance: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])


def compute_coefficients(betas: np.ndarray) -> DiffusionCoefficients:
    betas = np.asarray(betas, dtype=np.float64)
    if betas.ndim != 1 or not ((betas > 0).all() and (betas <= 1).all()):
        raise ValueError("betas must be a 1-D array in (0, 1]")

    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    alphas_cumprod_next = np.append(alphas_cumprod[1:], 0.0)

    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    # the posterior variance is 0 at t=0: the clipped log reuses the t=1 entry
    if len(posterior_variance) > 1:
        posterior_log_variance_clipped = np.log(
            np.append(posterior_variance[1], posterior_variance[1:])
        )
    else:
        posterior_log_variance_clipped = np.array([])

    fixed_large = np.append(posterior_variance[1], betas[1:])

    return DiffusionCoefficients(
        betas=betas,
        alphas_cumprod=alphas_cumprod,
        alphas_cumprod_prev=alphas_cumprod_prev,
        alphas_cumprod_next=alphas_cumprod_next,
        sqrt_alphas_cumprod=np.sqrt(alphas_cumprod),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - alphas_cumprod),
        log_one_minus_alphas_cumprod=np.log(1.0 - alphas_cumprod),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod - 1),
        posterior_variance=posterior_variance,
        posterior_log_variance_clipped=posterior_log_variance_clipped,
        posterior_mean_coef1=betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod),
        posterior_mean_coef2=(1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod),
        fixed_large_variance=fixed_large,
        fixed_large_log_variance=np.log(fixed_large),
    )


def space_timesteps(num_timesteps: int, section_counts: Union[str, Sequence[int]]) -> set:
    """Base timesteps kept when respacing: "ddimN" (fixed stride) or
    per-section fractional striding over a list (or comma string) of counts."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for stride in range(1, num_timesteps):
                if len(range(0, num_timesteps, stride)) == desired:
                    return set(range(0, num_timesteps, stride))
            raise ValueError(f"cannot create exactly {desired} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]

    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        frac_stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            all_steps.append(start_idx + round(cur))
            cur += frac_stride
        start_idx += size
    return set(all_steps)


def respaced_betas(base_betas: np.ndarray, use_timesteps) -> "tuple[np.ndarray, np.ndarray]":
    """Betas of the kept-timestep subset, and ``timestep_map`` (int32):
    ``timestep_map[i]`` is the base index of respaced step ``i``."""
    use_timesteps = set(use_timesteps)
    base = compute_coefficients(np.asarray(base_betas, dtype=np.float64))
    last_alpha_cumprod = 1.0
    new_betas = []
    timestep_map = []
    for i, alpha_cumprod in enumerate(base.alphas_cumprod):
        if i in use_timesteps:
            new_betas.append(1 - alpha_cumprod / last_alpha_cumprod)
            last_alpha_cumprod = alpha_cumprod
            timestep_map.append(i)
    return np.array(new_betas, dtype=np.float64), np.array(timestep_map, dtype=np.int32)
