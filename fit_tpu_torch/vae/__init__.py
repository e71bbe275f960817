"""The Stable-Diffusion VAE (AutoencoderKL) and its diffusers checkpoint loader."""

from fit_tpu_torch.vae.convert import (
    convert_state_dict,
    convert_torch_state_dict,
    load_autoencoder,
    load_checkpoint,
    load_torch_checkpoint,
    resolve_checkpoint,
)
from fit_tpu_torch.vae.model import SD_VAE_SCALING, AutoencoderKL, DiagonalGaussian, to_uint8

__all__ = [
    "SD_VAE_SCALING",
    "AutoencoderKL",
    "DiagonalGaussian",
    "convert_state_dict",
    "convert_torch_state_dict",
    "load_autoencoder",
    "load_checkpoint",
    "load_torch_checkpoint",
    "resolve_checkpoint",
    "to_uint8",
]
