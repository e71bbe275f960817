"""Gaussian diffusion and its sampling loops, and the rectified-flow loops of FLUX and Wan."""

from fit_tpu_torch._exports import lazy_exports

__all__, __getattr__, __dir__ = lazy_exports(
    __name__,
    {
        "..core.schedules": (
            "space_timesteps",
        ),
        ".flow": (
            "denoise",
            "denoise_guided",
            "get_schedule",
            "shifted_schedule",
        ),
        ".dpm_solver": (
            "dpm_solver_pp_2m",
        ),
        ".gaussian": (
            "GaussianDiffusion",
            "LossType",
            "ModelMeanType",
            "ModelVarType",
            "continuous_gaussian_log_likelihood",
            "create_diffusion",
            "discretized_gaussian_log_likelihood",
            "masked_global_mse",
            "normal_kl",
        ),
        ".samplers": (
            "cfg_model_fn",
            "ddim_reverse_loop",
            "ddim_sample_loop",
            "p_sample_loop",
        ),
        ".timestep_samplers": (
            "LossSecondMomentResampler",
            "UniformSampler",
            "create_named_schedule_sampler",
        ),
    },
)
