"""Sampling command line, with ``fit_tpu``'s flags and ``--device``.

    python -m fit_tpu_torch.cli.sample --checkpoint-path results/checkpoints \\
        --num-samples 50000 --num-sampling-steps 250 --cfg-scale 1.5 [--sampler dpm] \\
        [--vae-checkpoint sd-vae-ft-ema.bin]
    python -m fit_tpu_torch.cli.sample --torch-checkpoint last.ckpt --model FiT-XL/2 ...

Loads a model from one of three sources (:func:`load_model_and_params`):
the Trainer's checkpoint directory, a reference (PyTorch Lightning)
checkpoint, or an int8 artifact of ``fit_tpu_torch.cli.quantize``;
optionally quantizes it to int8 (``--quant int8``, with SmoothQuant on N
synthetic batches by ``--quant-equalize N``), then samples class-conditional
latents batch by batch, or packed over mixed sizes (``--image-sizes``), and
writes each as ``latent_{idx}_{label}.npy`` (fp16). With
``--vae-checkpoint`` (a diffusers sd-vae file, or a directory holding
``sd-vae-ft-{vae}.bin``) it decodes them instead, one batched decode per
batch (one per sample when packed), in ``--dtype``, and writes
``generated_image_{idx}_{label}.png`` (needs PIL). Its last line is each
kernel's launch count since its module's last reset (``[sample] kernel
launches: {...}``, the run's own in a process of its own). The ``config.json``
beside the checkpoint supplies the fields not given as flags. Runs on the
card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from fit_tpu_torch.models.fit import FiT, create_fit
from fit_tpu_torch.ops import launch_counts
from fit_tpu_torch.utils.config import SampleConfig, add_dataclass_args, from_args
from fit_tpu_torch.utils.device import resolve_device
from fit_tpu_torch.vae.model import to_uint8

__all__ = ["load_model_and_params", "batch_draws", "parse_sizes", "find_config", "read_config", "save_png", "main"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def parse_sizes(spec: str) -> List[Tuple[int, int]]:
    """"256x256,224x288" -> [(256, 256), (224, 288)]."""
    sizes = []
    for part in spec.replace(" ", ",").split(","):
        if not part:
            continue
        h, w = part.lower().split("x")
        sizes.append((int(h), int(w)))
    return sizes


def find_config(checkpoint_path: str) -> Optional[str]:
    """The ``config.json`` that goes with a checkpoint: beside its directory
    (a Trainer's results directory) or inside it (an int8 artifact)."""
    if not checkpoint_path:
        return None
    for cand in (
        os.path.join(os.path.dirname(checkpoint_path.rstrip("/")), "config.json"),
        os.path.join(checkpoint_path, "config.json"),
    ):
        if os.path.exists(cand):
            return cand
    return None


def read_config(parser: argparse.ArgumentParser, argv=None) -> Tuple[argparse.Namespace, SampleConfig]:
    """Parse ``argv`` with ``parser`` (which gets the ``SampleConfig``
    flags, ``--config`` and ``--device`` here). Fields come from
    ``--config`` or the checkpoint's ``config.json``, then from the flags
    given."""
    parser.add_argument("--config", type=str, default=None, help="JSON config file")
    parser.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    add_dataclass_args(parser, SampleConfig)
    args = parser.parse_args(argv)
    config_path = args.config or find_config(args.checkpoint_path)
    return args, from_args(SampleConfig, args, config_path)


def load_model_and_params(
    cfg: SampleConfig, torch_checkpoint: Optional[str] = None, quant: str = "none", equalize: int = 0, device="cuda"
) -> FiT:
    """The FiT of ``cfg`` on ``device`` (the card unless the caller names
    another) with its weights from, in order: the int8 artifact at
    ``cfg.checkpoint_path``, the reference checkpoint ``torch_checkpoint``,
    or the Trainer's checkpoint directory ``cfg.checkpoint_path`` (its
    latest step; the EMA weights when ``cfg.use_ema``). ``quant="int8"``
    then quantizes it, after SmoothQuant on ``equalize`` synthetic batches
    at ``cfg.image_height`` when that is not 0. Parameters stay in their
    stored dtype until a sampler casts them."""
    from fit_tpu_torch.ops.quant import is_quantized_artifact, load_quantized, quantize_model

    device = resolve_device(device)
    kw = dict(num_classes=cfg.num_classes, dtype=DTYPES[cfg.dtype], ffn=cfg.ffn, device=device)
    if cfg.checkpoint_path and is_quantized_artifact(cfg.checkpoint_path):
        state_dict, meta = load_quantized(cfg.checkpoint_path)
        model = create_fit(cfg.model, quant="int8", **kw)
        model.load_state_dict(state_dict)
        print(f"Loaded int8 serving artifact ({meta.get('scheme')}, model {meta.get('model', cfg.model)})")
        return model

    model = create_fit(cfg.model, **kw)
    if torch_checkpoint:
        from fit_tpu_torch.models.convert import load_torch_fit_checkpoint

        if not os.path.isfile(torch_checkpoint):
            raise FileNotFoundError(f"no checkpoint file {torch_checkpoint}")
        model.load_state_dict(load_torch_fit_checkpoint(torch_checkpoint, model.state_dict(), prefer_ema=cfg.use_ema))
        print(f"Converted torch checkpoint {torch_checkpoint}")
    else:
        from fit_tpu_torch.utils.checkpoint import CheckpointManager

        # CheckpointManager creates its directory: look before building one
        if not (cfg.checkpoint_path and os.path.isdir(cfg.checkpoint_path)):
            raise FileNotFoundError(f"no checkpoint directory {cfg.checkpoint_path!r}")
        payload, _ = CheckpointManager(cfg.checkpoint_path).restore()
        if payload is None:
            raise FileNotFoundError(f"no checkpoint under {cfg.checkpoint_path}")
        model.load_state_dict(payload["ema"] if cfg.use_ema else payload["model"])
        print(f"Model loaded (step {payload['step']}, ema={cfg.use_ema})")

    if quant == "int8":
        calib = None
        if equalize:
            from fit_tpu_torch.ops.equalize import synthetic_calib_batch

            rng = np.random.default_rng(0)
            calib = [synthetic_calib_batch(model, rng, batch=4, size=cfg.image_height) for _ in range(int(equalize))]
        model = quantize_model(model, calib_batches=calib)
        print("Quantized the block projections to int8 (w8a8)"
              + (f", equalized on {equalize} calibration batches" if equalize else ""))
    elif quant != "none":
        raise ValueError(f"unknown quant {quant!r}: use 'none' or 'int8'")
    return model


def batch_draws(global_seed: int, batch: int, n: int, num_classes: int, device) -> Tuple[List[int], torch.Generator]:
    """The labels and the noise generator of batch ``batch`` of a run
    seeded ``global_seed``: both come from one seed derived from the pair,
    so any batch can be drawn again on its own. The labels are drawn on the
    host; the generator is on ``device``, for the sampler's noise."""
    seed = int(np.random.SeedSequence([global_seed, batch]).generate_state(1)[0])
    labels = torch.randint(0, num_classes, (n,), generator=torch.Generator().manual_seed(seed))
    return labels.tolist(), torch.Generator(torch.device(device)).manual_seed(seed)


def save_png(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as a PNG (PIL)."""
    from PIL import Image

    Image.fromarray(image).save(path)


def main(argv=None) -> dict:
    """Run the command line. Returns what it sampled: ``latents`` (each
    (C, h, w) fp32, in sample order), ``labels``, ``seconds``, each batch's
    sampling time on the host clock, ending with its read-back, and with a
    VAE ``images``, each (H, W, 3) uint8 as written, and ``decode_seconds``,
    each batch's decode time on the host clock, ending with its read-back."""
    parser = argparse.ArgumentParser(description="Sample from a trained FiT with fit_tpu_torch")
    parser.add_argument("--torch-checkpoint", type=str, default=None,
                        help="sample from a reference (PyTorch Lightning) FiT checkpoint")
    parser.add_argument("--quant", choices=["none", "int8"], default="none",
                        help="int8: the w8a8 path for the block projections (fit_tpu_torch.ops.quant)")
    parser.add_argument("--quant-equalize", type=int, default=0, metavar="N",
                        help="with --quant int8: SmoothQuant on N synthetic calibration batches first")
    parser.add_argument("--vae-checkpoint", type=str, default=None,
                        help="a diffusers sd-vae checkpoint (file, or directory resolved by --vae): write PNGs")
    args, cfg = read_config(parser, argv)

    from fit_tpu_torch.sampling import FiTSampler

    model = load_model_and_params(
        cfg, torch_checkpoint=args.torch_checkpoint, quant=args.quant, equalize=args.quant_equalize,
        device=args.device,
    )
    sampler = FiTSampler(
        model, num_sampling_steps=cfg.num_sampling_steps, cfg_scale=cfg.cfg_scale, sampler=cfg.sampler,
        num_classes=cfg.num_classes, device=args.device,
    )
    vae = None
    if args.vae_checkpoint:
        from fit_tpu_torch.vae import load_autoencoder

        vae = load_autoencoder(args.vae_checkpoint, cfg.vae, dtype=DTYPES[cfg.dtype], device=args.device)
    os.makedirs(cfg.output_dir, exist_ok=True)
    mixed = parse_sizes(cfg.image_sizes) if cfg.image_sizes else None
    num_batches = math.ceil(cfg.num_samples / cfg.batch_size)
    result = {"latents": [], "labels": [], "seconds": []}
    if vae is not None:
        result.update(images=[], decode_seconds=[])
    for b in range(num_batches):
        n = min(cfg.batch_size, cfg.num_samples - b * cfg.batch_size)
        labels, generator = batch_draws(cfg.global_seed, b, n, cfg.num_classes, sampler.device)
        t0 = time.perf_counter()
        if mixed is not None:
            sizes = [mixed[(b * cfg.batch_size + i) % len(mixed)] for i in range(n)]
            on_card = sampler.sample_mixed(labels, sizes, generator=generator)
            latents = [lat.cpu().numpy() for lat in on_card]
        else:
            on_card = sampler.sample(labels, cfg.image_height, cfg.image_width, generator=generator)
            latents = list(on_card.cpu().numpy())
        seconds = time.perf_counter() - t0
        if vae is None:
            for i, (label, lat) in enumerate(zip(labels, latents)):
                idx = b * cfg.batch_size + i
                np.save(os.path.join(cfg.output_dir, f"latent_{idx}_{label}.npy"), lat.astype(np.float16))
        else:
            t0 = time.perf_counter()
            with torch.inference_mode():
                if mixed is not None:  # one decode per sample, each at its own size
                    images = [to_uint8(vae.decode(lat[None]))[0] for lat in on_card]
                else:  # one batched decode
                    images = list(to_uint8(vae.decode(on_card)))
            result["decode_seconds"].append(time.perf_counter() - t0)
            for i, (label, image) in enumerate(zip(labels, images)):
                save_png(os.path.join(cfg.output_dir, f"generated_image_{b * cfg.batch_size + i}_{label}.png"), image)
            result["images"] += images
        result["latents"] += latents
        result["labels"] += labels
        result["seconds"].append(seconds)
        print(f"batch {b + 1}/{num_batches}: {n} samples in {seconds:.3f} s "
              f"({seconds / cfg.num_sampling_steps * 1e3:.2f} ms a step)", flush=True)
    print(f"Wrote {cfg.num_samples} {'images' if vae is not None else 'latents'} to {cfg.output_dir}")
    print(f"[sample] kernel launches: {json.dumps(launch_counts())}", flush=True)
    return result


if __name__ == "__main__":
    main()
