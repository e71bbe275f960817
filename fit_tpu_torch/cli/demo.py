"""Demo sampling: the reference's fixed set of 8 class labels at high
guidance (CFG 15) from the EMA weights of a Trainer checkpoint.

    python -m fit_tpu_torch.cli.demo --checkpoint_path results/checkpoints \\
        [--model FiT-B/2] [--cfg_scale 15] [--vae-checkpoint sd-vae-ft-ema.bin] [--device cuda]

With ``--vae-checkpoint`` (a diffusers sd-vae file, or a directory holding
``sd-vae-ft-ema.bin``) it decodes the 8 samples in bf16 and writes them as
one 2 x 4 grid to ``--out`` (``sample.png``; needs PIL); without, it writes
the (8, C, h, w) latents to ``<out>_latents.npy``. Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fit_tpu_torch.cli.sample import load_model_and_params, save_png
from fit_tpu_torch.utils.config import SampleConfig

__all__ = ["DEMO_LABELS", "main"]

# the reference's demo labels
DEMO_LABELS = [207, 396, 372, 396, 88, 979, 417, 279]


def image_grid(images: np.ndarray, rows: int = 2) -> np.ndarray:
    """(N, H, W, 3) images -> one (rows * H, N / rows * W, 3) grid, row-major."""
    n, h, w, c = images.shape
    cols = n // rows
    return images.reshape(rows, cols, h, w, c).transpose(0, 2, 1, 3, 4).reshape(rows * h, cols * w, c)


def main(argv=None) -> np.ndarray:
    """Run the demo; returns the latents it sampled."""
    ap = argparse.ArgumentParser(description="Sample the demo labels from a FiT checkpoint")
    ap.add_argument("--checkpoint_path", type=str, required=True)
    ap.add_argument("--model", type=str, default="FiT-B/2")
    ap.add_argument("--num_sampling_steps", type=int, default=250)
    ap.add_argument("--cfg_scale", type=float, default=15.0)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--vae-checkpoint", type=str, default=None)
    ap.add_argument("--out", type=str, default="sample.png")
    ap.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    from fit_tpu_torch.sampling import FiTSampler

    cfg = SampleConfig(checkpoint_path=args.checkpoint_path, model=args.model, use_ema=True)
    model = load_model_and_params(cfg, device=args.device)
    sampler = FiTSampler(model, num_sampling_steps=args.num_sampling_steps, cfg_scale=args.cfg_scale,
                         device=args.device)
    generator = torch.Generator(sampler.device).manual_seed(0)
    latents = sampler.sample(DEMO_LABELS, args.image_size, args.image_size, generator=generator)
    if args.vae_checkpoint:
        from fit_tpu_torch.vae import load_autoencoder, to_uint8

        vae = load_autoencoder(args.vae_checkpoint, "ema", dtype=torch.bfloat16, device=args.device)
        with torch.inference_mode():
            grid = image_grid(to_uint8(vae.decode(latents)))
        save_png(args.out, grid)
        print(f"saved {args.out}")
    else:
        path = args.out.replace(".png", "_latents.npy")
        np.save(path, latents.cpu().numpy())
        print(f"no VAE weights; saved latents to {path}")
    return latents.cpu().numpy()


if __name__ == "__main__":
    main()
