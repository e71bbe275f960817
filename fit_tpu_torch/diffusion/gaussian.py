"""Gaussian diffusion: the q/p math of sampling and training, in torch.

Counterpart of ``fit_tpu/diffusion/gaussian.py``: eps or (``predict_xstart``)
x0 prediction with FIXED_LARGE, (``sigma_small``) FIXED_SMALL or
(``learn_sigma``) LEARNED_RANGE variance over any named noise schedule;
DDPM, DDIM and reverse-DDIM steps with the ``denoised_fn`` and ``cond_fn``
hooks; timestep respacing; the forward process ``q_sample``; the training
losses of every ``LossType``: the masked MSE, the variational-bound term
``vb`` that ``learn_sigma`` training adds (``RESCALED_MSE`` with
``rescale_learned_sigmas``), and the pure VLB loss (``RESCALED_KL`` with
``use_kl``); and the bits-per-dim metrics ``prior_bpd`` and
``calc_bpd_loop``. The coefficient tables
are float64 numpy; a step indexes a table and rounds the value to float32,
as ``fit_tpu`` does. Each table is copied to a device once and indexed
there, so a sampling loop makes no host round trip.
"""

from __future__ import annotations

import enum
import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from fit_tpu_torch.core.schedules import (
    compute_coefficients,
    named_beta_schedule,
    respaced_betas,
    space_timesteps,
)

__all__ = [
    "ModelMeanType",
    "ModelVarType",
    "LossType",
    "GaussianDiffusion",
    "create_diffusion",
    "mean_flat",
    "masked_mean_flat",
    "masked_global_mse",
    "normal_kl",
    "approx_standard_normal_cdf",
    "continuous_gaussian_log_likelihood",
    "discretized_gaussian_log_likelihood",
]

ModelFn = Callable[..., torch.Tensor]


class ModelMeanType(enum.Enum):
    """What the model predicts; the port takes EPSILON and START_X."""

    PREVIOUS_X = enum.auto()
    START_X = enum.auto()
    EPSILON = enum.auto()


class ModelVarType(enum.Enum):
    """The reverse step's variance; the port takes all but LEARNED."""

    LEARNED = enum.auto()
    FIXED_SMALL = enum.auto()
    FIXED_LARGE = enum.auto()
    LEARNED_RANGE = enum.auto()


class LossType(enum.Enum):
    MSE = enum.auto()
    RESCALED_MSE = enum.auto()  # the MSE, plus the vb term scaled by num_timesteps / 1000
    KL = enum.auto()  # the variational bound alone
    RESCALED_KL = enum.auto()  # the variational bound times num_timesteps

    def is_vb(self) -> bool:
        return self in (LossType.KL, LossType.RESCALED_KL)


def normal_kl(mean1, logvar1, mean2, logvar2) -> torch.Tensor:
    """KL(N(mean1, exp(logvar1)) || N(mean2, exp(logvar2))) elementwise, in
    nats; any argument may be a float, the others broadcast."""
    ref = next(x for x in (mean1, logvar1, mean2, logvar2) if isinstance(x, torch.Tensor))
    logvar1, logvar2 = (torch.as_tensor(v, dtype=ref.dtype, device=ref.device) for v in (logvar1, logvar2))
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2) + (mean1 - mean2) ** 2 * torch.exp(-logvar2))


def approx_standard_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    """The standard normal CDF by its tanh approximation."""
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x**3)))


def continuous_gaussian_log_likelihood(x: torch.Tensor, *, means, log_scales) -> torch.Tensor:
    """The log density of ``x`` under N(means, exp(log_scales)^2) at the
    standardized point, in nats (``fit_tpu``'s formula)."""
    normalized = (x - means) * torch.exp(-log_scales)
    return -0.5 * (normalized**2 + math.log(2 * math.pi))


def discretized_gaussian_log_likelihood(x: torch.Tensor, *, means, log_scales) -> torch.Tensor:
    """Log-likelihood of ``x`` (uint8 levels rescaled to [-1, 1]) under a
    Gaussian discretized to the 256 bins, the outer bins open-ended."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus, torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))


def _extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """``table[t]`` (an fp32 table on t's device) broadcast to ``ndim`` dims."""
    vals = table[t]
    return vals.reshape(vals.shape + (1,) * (ndim - 1))


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Per-sample mean over every axis but the first."""
    return x.mean(dim=tuple(range(1, x.dim())))


def masked_mean_flat(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-sample mean over valid elements only; ``mask`` (N, T) boolean is
    broadcast over the trailing axes of ``x`` (N, T, ...)."""
    if mask is None:
        return mean_flat(x)
    m = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim())).to(x.dtype)
    axes = tuple(range(1, x.dim()))
    num = m.sum(dim=axes).clamp(min=1.0)
    per_token = float(np.prod(x.shape[mask.dim():])) if x.dim() > mask.dim() else 1.0
    return (x * m).sum(dim=axes) / (num * per_token)


def masked_global_mse(model_output: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """One mean of the squared error over every valid element of the batch:
    the reference training step's ``F.mse_loss(out[mask], noise[mask])``."""
    m = mask.reshape(mask.shape + (1,) * (model_output.dim() - mask.dim()))
    se = torch.where(m, (model_output - target) ** 2, 0.0)
    per_token = float(np.prod(model_output.shape[mask.dim():])) if model_output.dim() > mask.dim() else 1.0
    denom = m.to(se.dtype).sum() * per_token
    return se.sum() / denom.clamp(min=1.0)


class GaussianDiffusion:
    """A (possibly respaced) Gaussian diffusion process.

    The model predicts eps, or x0 with ``predict_xstart`` (START_X). Its
    variance is FIXED_LARGE, FIXED_SMALL (``sigma_small``: the posterior
    variance) or, with ``learn_sigma``, LEARNED_RANGE: the output carries a
    second half of channels that interpolates the log variance.
    ``timestep_map`` maps local step indices to the base process's
    timesteps, which the model was trained on (``None``: not respaced).
    ``original_num_steps`` is the base process's length (the range training
    draws timesteps from). ``loss_type`` chooses the training loss
    (:class:`LossType`). ``fit_tpu``'s ``model_mean_type`` and
    ``model_var_type`` enums may be given instead of the booleans; a
    boolean that contradicts them raises.
    """

    def __init__(
        self,
        betas: np.ndarray,
        learn_sigma: bool = False,
        timestep_map: Optional[np.ndarray] = None,
        original_num_steps: Optional[int] = None,
        *,
        predict_xstart: bool = False,
        sigma_small: bool = False,
        loss_type: LossType = LossType.MSE,
        model_mean_type: Optional[ModelMeanType] = None,
        model_var_type: Optional[ModelVarType] = None,
    ):
        if model_mean_type is not None:
            if model_mean_type == ModelMeanType.PREVIOUS_X:
                raise ValueError("the port predicts eps or x0: ModelMeanType.PREVIOUS_X is not supported")
            if predict_xstart and model_mean_type != ModelMeanType.START_X:
                raise ValueError(f"predict_xstart=True contradicts {model_mean_type}")
            predict_xstart = model_mean_type == ModelMeanType.START_X
        if model_var_type is not None:
            if model_var_type == ModelVarType.LEARNED:
                raise ValueError("the port learns the variance as LEARNED_RANGE: ModelVarType.LEARNED is not supported")
            if (learn_sigma, sigma_small) not in ((False, False), self._var_flags(model_var_type)):
                raise ValueError(f"learn_sigma={learn_sigma}, sigma_small={sigma_small} contradict {model_var_type}")
            learn_sigma, sigma_small = self._var_flags(model_var_type)
        self.betas = np.asarray(betas, dtype=np.float64)
        self.loss_type = loss_type
        self.learn_sigma = learn_sigma
        self.predict_xstart = predict_xstart
        self.sigma_small = sigma_small
        self.timestep_map = timestep_map
        self.original_num_steps = len(self.betas) if original_num_steps is None else original_num_steps
        self.c = compute_coefficients(self.betas)
        self._device_tables: Dict[Tuple[str, torch.device], torch.Tensor] = {}

    @staticmethod
    def _var_flags(var_type: ModelVarType) -> "tuple[bool, bool]":
        """(learn_sigma, sigma_small) of a variance type."""
        return var_type == ModelVarType.LEARNED_RANGE, var_type == ModelVarType.FIXED_SMALL

    @property
    def model_mean_type(self) -> ModelMeanType:
        return ModelMeanType.START_X if self.predict_xstart else ModelMeanType.EPSILON

    @property
    def model_var_type(self) -> ModelVarType:
        if self.learn_sigma:
            return ModelVarType.LEARNED_RANGE
        return ModelVarType.FIXED_SMALL if self.sigma_small else ModelVarType.FIXED_LARGE

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
            elif name == "one_minus_alphas_cumprod":
                host = torch.from_numpy((1.0 - self.c.alphas_cumprod).astype(np.float32))
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

    def q_mean_variance(self, x_start, t):
        """Moments of q(x_t | x_0): mean, variance, log variance."""
        nd = x_start.dim()
        mean = self._x("sqrt_alphas_cumprod", t, nd) * x_start
        return mean, self._x("one_minus_alphas_cumprod", t, nd), self._x("log_one_minus_alphas_cumprod", t, nd)

    def q_sample(self, x_start, t, noise):
        """A draw of q(x_t | x_0) with the given noise."""
        nd = x_start.dim()
        return (
            self._x("sqrt_alphas_cumprod", t, nd) * x_start
            + self._x("sqrt_one_minus_alphas_cumprod", t, nd) * noise
        )

    def training_losses(self, model_fn: ModelFn, x_start, t, noise, mask=None) -> dict:
        """Training loss terms, per sample, over the valid tokens (``mask``
        (N, T)). ``mse``: the squared error against eps (x0 with
        ``predict_xstart``). With ``learn_sigma`` the output's second half
        of axis 1 is the variance, learned through ``vb``, the
        variational-bound term, which reaches the model through the variance
        half only (the mean half is detached there). ``loss`` is ``mse``
        plus ``vb``, or under a KL loss type the bound alone."""
        x_t = self.q_sample(x_start, t, noise)
        terms = {}
        if self.loss_type.is_vb():
            terms["loss"] = self.vb_terms_bpd(model_fn, x_start, x_t, t, clip_denoised=False, mask=mask)["output"]
            if self.loss_type == LossType.RESCALED_KL:
                terms["loss"] = terms["loss"] * self.num_timesteps
            return terms
        model_output = model_fn(x_t, t)
        if self.learn_sigma:
            model_output, var_values = model_output.chunk(2, dim=1)
            frozen = torch.cat([model_output.detach(), var_values], dim=1)
            terms["vb"] = self.vb_terms_bpd(
                lambda *_args: frozen, x_start, x_t, t, clip_denoised=False, mask=mask
            )["output"]
            if self.loss_type == LossType.RESCALED_MSE:
                terms["vb"] = terms["vb"] * (self.num_timesteps / 1000.0)
        target = x_start if self.predict_xstart else noise
        terms["mse"] = masked_mean_flat((target - model_output) ** 2, mask)
        terms["loss"] = terms["mse"] + terms["vb"] if "vb" in terms else terms["mse"]
        return terms

    def vb_terms_bpd(self, model_fn: ModelFn, x_start, x_t, t, clip_denoised: bool = True, mask=None) -> dict:
        """The variational bound's term at t, in bits per dimension, per
        sample over the valid tokens: the KL of the model's p(x_{t-1} | x_t)
        from the posterior q(x_{t-1} | x_t, x_0), or at t = 0 the decoder's
        negative log-likelihood of x_0. Returns ``output`` and
        ``pred_xstart``."""
        true_mean, _, true_log_var = self.q_posterior_mean_variance(x_start, x_t, t)
        out = self.p_mean_variance(model_fn, x_t, t, clip_denoised)
        kl = normal_kl(true_mean, true_log_var, out["mean"], out["log_variance"])
        kl = masked_mean_flat(kl, mask) / math.log(2.0)
        decoder_nll = -discretized_gaussian_log_likelihood(
            x_start, means=out["mean"], log_scales=0.5 * out["log_variance"]
        )
        decoder_nll = masked_mean_flat(decoder_nll, mask) / math.log(2.0)
        return {"output": torch.where(t == 0, decoder_nll, kl), "pred_xstart": out["pred_xstart"]}

    def prior_bpd(self, x_start) -> torch.Tensor:
        """KL(q(x_T | x_0) || N(0, I)) per sample, in bits per dimension."""
        t = torch.full((x_start.shape[0],), self.num_timesteps - 1, dtype=torch.long, device=x_start.device)
        qt_mean, _, qt_log_var = self.q_mean_variance(x_start, t)
        return mean_flat(normal_kl(qt_mean, qt_log_var, 0.0, 0.0)) / math.log(2.0)

    def calc_bpd_loop(
        self, model_fn: ModelFn, x_start, generator: Optional[torch.Generator] = None, clip_denoised: bool = True,
        noise=None,
    ) -> dict:
        """The whole variational bound of ``x_start``, over every timestep
        from the last to 0. Each step's noise is ``noise[t]`` when ``noise``
        (indexed by timestep, each of ``x_start``'s shape) is given, else a
        draw from ``generator`` on ``x_start``'s device. Returns per sample
        ``total_bpd`` and ``prior_bpd``, and per sample and step (columns in
        descending t) ``vb``, ``xstart_mse`` and ``mse`` (of eps)."""
        model_fn = self.wrap_model(model_fn)
        n = x_start.shape[0]
        vb, xstart_mse, mse = [], [], []
        for ti in range(self.num_timesteps - 1, -1, -1):
            if noise is not None:
                eps = torch.as_tensor(noise[ti], device=x_start.device)
            else:
                eps = torch.randn(x_start.shape, generator=generator, device=x_start.device, dtype=x_start.dtype)
            t_b = torch.full((n,), ti, dtype=torch.long, device=x_start.device)
            x_t = self.q_sample(x_start, t_b, eps)
            out = self.vb_terms_bpd(model_fn, x_start, x_t, t_b, clip_denoised)
            pred_eps = self._predict_eps_from_xstart(x_t, t_b, out["pred_xstart"])
            vb.append(out["output"])
            xstart_mse.append(mean_flat((out["pred_xstart"] - x_start) ** 2))
            mse.append(mean_flat((pred_eps - eps) ** 2))
        vb, xstart_mse, mse = (torch.stack(a, dim=1) for a in (vb, xstart_mse, mse))
        prior = self.prior_bpd(x_start)
        return {"total_bpd": vb.sum(dim=1) + prior, "prior_bpd": prior, "vb": vb, "xstart_mse": xstart_mse, "mse": mse}

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

    def p_mean_variance(self, model_fn: ModelFn, x, t, clip_denoised: bool = True, denoised_fn=None) -> dict:
        """Moments of p(x_{t-1} | x_t) and the x0 prediction; ``model_fn``
        is already wrapped (:meth:`wrap_model`) and bound to its conditioning.
        ``denoised_fn(x0)`` transforms the x0 prediction before the clip."""
        nd = x.dim()
        out = model_fn(x, t)
        if self.learn_sigma:
            out, var_values = out.chunk(2, dim=1)
            min_log = self._x("posterior_log_variance_clipped", t, nd)
            max_log = self._x("log_betas", t, nd)
            frac = (var_values + 1) / 2
            model_log_variance = frac * max_log + (1 - frac) * min_log
            model_variance = torch.exp(model_log_variance)
        elif self.sigma_small:
            model_variance = self._x("posterior_variance", t, nd)
            model_log_variance = self._x("posterior_log_variance_clipped", t, nd)
        else:
            model_variance = self._x("fixed_large_variance", t, nd)
            model_log_variance = self._x("fixed_large_log_variance", t, nd)

        pred_xstart = out if self.predict_xstart else self._predict_xstart_from_eps(x, t, out)
        if denoised_fn is not None:
            pred_xstart = denoised_fn(pred_xstart)
        if clip_denoised:
            pred_xstart = pred_xstart.clamp(-1, 1)
        model_mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x, t)
        return {
            "mean": model_mean,
            "variance": model_variance,
            "log_variance": model_log_variance,
            "pred_xstart": pred_xstart,
        }

    def condition_mean(self, cond_fn, p_mean_var: dict, x, t) -> torch.Tensor:
        """The mean shifted by the variance times ``cond_fn(x, t)``, the
        gradient of a log-likelihood (classifier guidance)."""
        gradient = cond_fn(x, t)
        return p_mean_var["mean"].float() + p_mean_var["variance"] * gradient.float()

    def condition_score(self, cond_fn, p_mean_var: dict, x, t) -> dict:
        """``p_mean_var`` with eps moved by ``-sqrt(1 - alpha_bar) *
        cond_fn(x, t)`` and x0 and the mean recomputed from it (the score
        form of guidance, for DDIM)."""
        alpha_bar = self._x("alphas_cumprod", t, x.dim())
        eps = self._predict_eps_from_xstart(x, t, p_mean_var["pred_xstart"])
        eps = eps - torch.sqrt(1 - alpha_bar) * cond_fn(x, t)
        out = dict(p_mean_var)
        out["pred_xstart"] = self._predict_xstart_from_eps(x, t, eps)
        out["mean"], _, _ = self.q_posterior_mean_variance(out["pred_xstart"], x, t)
        return out

    def p_sample(
        self, model_fn: ModelFn, x, t, noise, clip_denoised: bool = True, denoised_fn=None, cond_fn=None
    ) -> dict:
        """One DDPM ancestral step with explicit noise."""
        out = self.p_mean_variance(model_fn, x, t, clip_denoised, denoised_fn)
        nonzero = (t != 0).to(x.dtype).reshape((-1,) + (1,) * (x.dim() - 1))
        if cond_fn is not None:
            out["mean"] = self.condition_mean(cond_fn, out, x, t)
        sample = out["mean"] + nonzero * torch.exp(0.5 * out["log_variance"]) * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def ddim_sample(
        self,
        model_fn: ModelFn,
        x,
        t,
        noise=None,
        clip_denoised: bool = True,
        denoised_fn=None,
        cond_fn=None,
        eta: float = 0.0,
    ) -> dict:
        """One DDIM step; deterministic (no noise) at ``eta=0``."""
        out = self.p_mean_variance(model_fn, x, t, clip_denoised, denoised_fn)
        if cond_fn is not None:
            out = self.condition_score(cond_fn, out, x, t)
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

    def ddim_reverse_sample(
        self, model_fn: ModelFn, x, t, clip_denoised: bool = True, denoised_fn=None, cond_fn=None
    ) -> dict:
        """One step of the DDIM reverse ODE (encoding), from t to t + 1."""
        out = self.p_mean_variance(model_fn, x, t, clip_denoised, denoised_fn)
        if cond_fn is not None:
            out = self.condition_score(cond_fn, out, x, t)
        eps = self._predict_eps_from_xstart(x, t, out["pred_xstart"])
        alpha_bar_next = self._x("alphas_cumprod_next", t, x.dim())
        mean_pred = out["pred_xstart"] * torch.sqrt(alpha_bar_next) + torch.sqrt(1 - alpha_bar_next) * eps
        return {"sample": mean_pred, "pred_xstart": out["pred_xstart"]}


def create_diffusion(
    timestep_respacing: Union[str, Sequence[int], None],
    noise_schedule: str = "linear",
    use_kl: bool = False,
    sigma_small: bool = False,
    predict_xstart: bool = False,
    learn_sigma: bool = False,
    rescale_learned_sigmas: bool = False,
    diffusion_steps: int = 1000,
) -> GaussianDiffusion:
    """``fit_tpu``'s factory and defaults: ``noise_schedule`` betas over
    ``diffusion_steps`` base steps, eps prediction, FIXED_LARGE variance,
    the MSE loss, respaced to ``timestep_respacing``. ``use_kl`` selects
    the RESCALED_KL loss, else ``rescale_learned_sigmas`` RESCALED_MSE."""
    if use_kl:
        loss_type = LossType.RESCALED_KL
    elif rescale_learned_sigmas:
        loss_type = LossType.RESCALED_MSE
    else:
        loss_type = LossType.MSE
    betas = named_beta_schedule(noise_schedule, diffusion_steps)
    if timestep_respacing is None or timestep_respacing == "":
        timestep_respacing = [diffusion_steps]
    keep = space_timesteps(diffusion_steps, timestep_respacing)
    new_betas, tmap = respaced_betas(betas, keep)
    return GaussianDiffusion(
        new_betas,
        learn_sigma=learn_sigma,
        timestep_map=tmap if len(keep) != diffusion_steps else None,
        original_num_steps=diffusion_steps,
        predict_xstart=predict_xstart,
        sigma_small=sigma_small,
        loss_type=loss_type,
    )
