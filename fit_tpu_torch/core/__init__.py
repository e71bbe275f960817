"""Host-side math: positional tables, patch geometry, noise schedules."""

from fit_tpu_torch._exports import lazy_exports

__all__, __getattr__, __dir__ = lazy_exports(
    __name__,
    {
        ".geometry": (
            "pad_latent_to_canvas",
            "pad_tokens",
            "patchify",
            "patchify_np",
            "token_count",
            "unpad_latent",
            "unpatchify",
        ),
        ".pos_embed": (
            "get_1d_sincos_pos_embed",
            "get_2d_sincos_pos_embed",
            "grid_positions_2d",
            "ntk_scaled_theta",
            "precompute_freqs_cis_2d",
            "rope_freqs_1d_from_positions",
            "rope_freqs_2d",
            "sincos_1d",
            "sincos_2d",
        ),
        ".schedules": (
            "DiffusionCoefficients",
            "beta_schedule",
            "betas_from_alpha_bar",
            "compute_coefficients",
            "named_beta_schedule",
            "respaced_betas",
            "space_timesteps",
        ),
    },
)
