"""Demo sampling: the reference's fixed set of 8 class labels at high
guidance (CFG 15) from the EMA weights of a Trainer checkpoint.

    python -m fit_tpu_torch.cli.demo --checkpoint_path results/checkpoints \\
        [--model FiT-B/2] [--cfg_scale 15] [--device cuda]

Writes the (8, C, h, w) latents to ``<out>_latents.npy`` (``--out``
``sample.png`` by default); the image grid waits for the VAE. Runs on the
card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fit_tpu_torch.cli.sample import load_model_and_params
from fit_tpu_torch.utils.config import SampleConfig

__all__ = ["DEMO_LABELS", "main"]

# the reference's demo labels
DEMO_LABELS = [207, 396, 372, 396, 88, 979, 417, 279]


def main(argv=None) -> np.ndarray:
    """Run the demo; returns the latents it wrote."""
    ap = argparse.ArgumentParser(description="Sample the demo labels from a FiT checkpoint")
    ap.add_argument("--checkpoint_path", type=str, required=True)
    ap.add_argument("--model", type=str, default="FiT-B/2")
    ap.add_argument("--num_sampling_steps", type=int, default=250)
    ap.add_argument("--cfg_scale", type=float, default=15.0)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--out", type=str, default="sample.png")
    ap.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    from fit_tpu_torch.sampling import FiTSampler

    cfg = SampleConfig(checkpoint_path=args.checkpoint_path, model=args.model, use_ema=True)
    model = load_model_and_params(cfg, device=args.device)
    sampler = FiTSampler(model, num_sampling_steps=args.num_sampling_steps, cfg_scale=args.cfg_scale,
                         device=args.device)
    generator = torch.Generator(sampler.device).manual_seed(0)
    latents = sampler.sample(DEMO_LABELS, args.image_size, args.image_size, generator=generator).cpu().numpy()
    path = args.out.replace(".png", "_latents.npy")
    np.save(path, latents)
    print(f"no VAE yet; saved latents to {path}")
    return latents


if __name__ == "__main__":
    main()
