"""Gaussian diffusion: the q/p math sampling needs, in torch.

Counterpart of ``fit_tpu/diffusion/gaussian.py`` for what sampling needs:
eps prediction with FIXED_LARGE or (``learn_sigma``) LEARNED_RANGE
variance, DDPM and DDIM steps, timestep respacing. The coefficient tables
are float64 numpy; a step indexes a table and rounds the value to float32,
as ``fit_tpu`` does. Each table is copied to a device once and indexed
there, so a sampling loop makes no host round trip.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from fit_tpu_torch.core.schedules import (
    compute_coefficients,
    named_beta_schedule,
    respaced_betas,
    space_timesteps,
)

__all__ = ["GaussianDiffusion", "create_diffusion"]

ModelFn = Callable[..., torch.Tensor]


def _extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """``table[t]`` (an fp32 table on t's device) broadcast to ``ndim`` dims."""
    vals = table[t]
    return vals.reshape(vals.shape + (1,) * (ndim - 1))


class GaussianDiffusion:
    """A (possibly respaced) Gaussian diffusion process over an eps model.

    ``learn_sigma``: the model's output carries a second half of channels
    that interpolates the log variance (LEARNED_RANGE); otherwise the
    variance is FIXED_LARGE. ``timestep_map`` maps local step indices to
    the base process's timesteps, which the model was trained on (``None``:
    not respaced).
    """

    def __init__(
        self,
        betas: np.ndarray,
        learn_sigma: bool = False,
        timestep_map: Optional[np.ndarray] = None,
    ):
        self.betas = np.asarray(betas, dtype=np.float64)
        self.learn_sigma = learn_sigma
        self.timestep_map = timestep_map
        self.c = compute_coefficients(self.betas)
        self._device_tables: Dict[Tuple[str, torch.device], torch.Tensor] = {}

    @property
    def num_timesteps(self) -> int:
        return self.c.num_timesteps

    def _table(self, name: str, device: torch.device) -> torch.Tensor:
        key = (name, device)
        if key not in self._device_tables:
            if name == "timestep_map":
                host = torch.from_numpy(self.timestep_map.astype(np.int64))
            elif name == "log_betas":
                host = torch.from_numpy(np.log(self.c.betas).astype(np.float32))
            else:
                host = torch.from_numpy(getattr(self.c, name).astype(np.float32))
            self._device_tables[key] = host.to(device)
        return self._device_tables[key]

    def _x(self, name: str, t: torch.Tensor, ndim: int) -> torch.Tensor:
        return _extract(self._table(name, t.device), t, ndim)

    def wrap_model(self, model_fn: ModelFn) -> ModelFn:
        """Remap local timesteps to base-process indices before the model."""
        if self.timestep_map is None:
            return model_fn

        def wrapped(x, ts, **kwargs):
            return model_fn(x, self._table("timestep_map", ts.device)[ts], **kwargs)

        return wrapped

    def q_posterior_mean_variance(self, x_start, x_t, t):
        mean = (
            self._x("posterior_mean_coef1", t, x_t.dim()) * x_start
            + self._x("posterior_mean_coef2", t, x_t.dim()) * x_t
        )
        variance = self._x("posterior_variance", t, x_t.dim())
        log_variance = self._x("posterior_log_variance_clipped", t, x_t.dim())
        return mean, variance, log_variance

    def _predict_xstart_from_eps(self, x_t, t, eps):
        return (
            self._x("sqrt_recip_alphas_cumprod", t, x_t.dim()) * x_t
            - self._x("sqrt_recipm1_alphas_cumprod", t, x_t.dim()) * eps
        )

    def _predict_eps_from_xstart(self, x_t, t, pred_xstart):
        return (
            self._x("sqrt_recip_alphas_cumprod", t, x_t.dim()) * x_t - pred_xstart
        ) / self._x("sqrt_recipm1_alphas_cumprod", t, x_t.dim())

    def p_mean_variance(self, model_fn: ModelFn, x, t, clip_denoised: bool = True) -> dict:
        """Moments of p(x_{t-1} | x_t) and the x0 prediction; ``model_fn``
        is already wrapped (:meth:`wrap_model`) and bound to its conditioning."""
        nd = x.dim()
        eps = model_fn(x, t)
        if self.learn_sigma:
            eps, var_values = eps.chunk(2, dim=1)
            min_log = self._x("posterior_log_variance_clipped", t, nd)
            max_log = self._x("log_betas", t, nd)
            frac = (var_values + 1) / 2
            model_log_variance = frac * max_log + (1 - frac) * min_log
            model_variance = torch.exp(model_log_variance)
        else:
            model_variance = self._x("fixed_large_variance", t, nd)
            model_log_variance = self._x("fixed_large_log_variance", t, nd)

        pred_xstart = self._predict_xstart_from_eps(x, t, eps)
        if clip_denoised:
            pred_xstart = pred_xstart.clamp(-1, 1)
        model_mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x, t)
        return {
            "mean": model_mean,
            "variance": model_variance,
            "log_variance": model_log_variance,
            "pred_xstart": pred_xstart,
        }

    def p_sample(self, model_fn: ModelFn, x, t, noise, clip_denoised: bool = True) -> dict:
        """One DDPM ancestral step with explicit noise."""
        out = self.p_mean_variance(model_fn, x, t, clip_denoised)
        nonzero = (t != 0).to(x.dtype).reshape((-1,) + (1,) * (x.dim() - 1))
        sample = out["mean"] + nonzero * torch.exp(0.5 * out["log_variance"]) * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def ddim_sample(
        self, model_fn: ModelFn, x, t, noise=None, clip_denoised: bool = True, eta: float = 0.0
    ) -> dict:
        """One DDIM step; deterministic (no noise) at ``eta=0``."""
        out = self.p_mean_variance(model_fn, x, t, clip_denoised)
        eps = self._predict_eps_from_xstart(x, t, out["pred_xstart"])
        alpha_bar = self._x("alphas_cumprod", t, x.dim())
        alpha_bar_prev = self._x("alphas_cumprod_prev", t, x.dim())
        sigma = (
            eta
            * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
            * torch.sqrt(1 - alpha_bar / alpha_bar_prev)
        )
        mean_pred = (
            out["pred_xstart"] * torch.sqrt(alpha_bar_prev)
            + torch.sqrt(1 - alpha_bar_prev - sigma**2) * eps
        )
        if eta == 0.0:
            sample = mean_pred
        else:
            if noise is None:
                raise ValueError("DDIM with eta > 0 needs noise")
            nonzero = (t != 0).to(x.dtype).reshape((-1,) + (1,) * (x.dim() - 1))
            sample = mean_pred + nonzero * sigma * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}


def create_diffusion(
    timestep_respacing: Union[str, Sequence[int], None],
    learn_sigma: bool = False,
    diffusion_steps: int = 1000,
) -> GaussianDiffusion:
    """The reference defaults: linear betas over ``diffusion_steps`` base
    steps, eps prediction, respaced to ``timestep_respacing``."""
    betas = named_beta_schedule("linear", diffusion_steps)
    if timestep_respacing is None or timestep_respacing == "":
        timestep_respacing = [diffusion_steps]
    keep = space_timesteps(diffusion_steps, timestep_respacing)
    new_betas, tmap = respaced_betas(betas, keep)
    return GaussianDiffusion(
        new_betas,
        learn_sigma=learn_sigma,
        timestep_map=tmap if len(keep) != diffusion_steps else None,
    )
