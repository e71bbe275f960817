"""Preprocessing command line: VAE-encode an image tree into fp16 latents,
with ``fit_tpu``'s ``--config`` and flags and ``--device``.

    python -m fit_tpu_torch.cli.preprocess --config config.json \\
        --vae-checkpoint sd-vae-ft-ema/diffusion_pytorch_model.bin [--device cuda]
    python -m fit_tpu_torch.cli.preprocess --dataset-path imgs/ --latent-folder latents/ \\
        --vae-checkpoint vae_dir/ --vae mse --batch-size 8 --sample-size 256

``config.json`` holds ``PreprocessConfig`` fields (``dataset_path``,
``latent_folder``, ``batch_size``, ...); flags override them.
``--vae-checkpoint`` is a diffusers ``AutoencoderKL`` file, or a directory
holding ``sd-vae-ft-{vae}.bin``; without one the VAE has random weights
(seed 0), which only a pipeline smoke test wants. Encodes in fp32 on the
card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
from typing import List

import torch

from fit_tpu_torch.utils.config import PreprocessConfig, add_dataclass_args, from_args

__all__ = ["main"]


def main(argv=None) -> List[str]:
    """Run the command line; returns the latent paths written."""
    parser = argparse.ArgumentParser(description="VAE-encode an image dataset with fit_tpu_torch")
    parser.add_argument("--config", type=str, default=None, help="JSON config file")
    parser.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    add_dataclass_args(parser, PreprocessConfig)
    args = parser.parse_args(argv)
    cfg = from_args(PreprocessConfig, args, args.config)

    from fit_tpu_torch.data.preprocess import preprocess_folder
    from fit_tpu_torch.utils.device import resolve_device
    from fit_tpu_torch.vae import AutoencoderKL, load_autoencoder

    device = resolve_device(args.device)
    if cfg.vae_checkpoint:
        vae = load_autoencoder(cfg.vae_checkpoint, cfg.vae, dtype=torch.float32, device=device)
    else:
        print("[preprocess] WARNING: no --vae-checkpoint given; using random VAE weights "
              "(useful only for pipeline smoke tests)", flush=True)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            vae = AutoencoderKL(device="cpu").to(device)
    written = preprocess_folder(
        cfg.dataset_path, cfg.latent_folder, vae, max_size=cfg.sample_size, patch_size=cfg.patch_size,
        batch_size=max(cfg.batch_size, 1),
    )
    print(f"[preprocess] wrote {len(written)} latents -> {cfg.latent_folder}", flush=True)
    return written


if __name__ == "__main__":
    main()
