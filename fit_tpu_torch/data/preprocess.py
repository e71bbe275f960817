"""Offline VAE preprocessing: an image tree -> fp16 latent ``.npy`` files.

Counterpart of ``fit_tpu/data/preprocess.py``: walk an image tree, resize
each image (PIL bicubic) so that its area is at most ``max_size^2`` with
its aspect ratio kept and its sides rounded to multiples of ``vae_scale *
patch_size``, VAE-encode, scale by 0.18215, save one fp16 ``.npy`` per
image mirroring the class layout, write the ``path.json`` manifest, and
skip images whose latent is already written. Images of one rounded shape
are encoded together in batches; a draw of the posterior takes its noise
from one ``torch.Generator`` seeded by ``seed`` on the VAE's device, one
draw per batch. The latents load through
``fit_tpu_torch.data.dataset.LatentFolderDataset``.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

ALLOWED_FORMAT = {".jpeg", ".jpg", ".bmp", ".png"}

__all__ = ["resize_dims", "resize_by_max_value", "walk_images", "encode_batch", "preprocess_folder"]


def resize_dims(w: int, h: int, max_size: int = 256, scale: int = 16) -> Tuple[int, int]:
    """The target (w, h): area at most ``max_size^2``, aspect ratio kept,
    sides multiples of ``scale`` (at least one ``scale``)."""
    image_area = w * h
    max_area = max_size * max_size
    if image_area > max_area:
        ratio = max_area / image_area
        new_w = w * np.sqrt(ratio)
        new_h = h * np.sqrt(ratio)
    else:
        new_w, new_h = w, h
    round_w, round_h = (np.round(np.array([new_w, new_h]) / scale) * scale).astype(int).tolist()
    if round_w * round_h > max_area:
        round_w, round_h = (np.floor(np.array([new_w, new_h]) / scale) * scale).astype(int).tolist()
    return max(round_w, scale), max(round_h, scale)


def resize_by_max_value(img, max_size: int = 256, vae_scale: int = 8, patch_size: int = 2):
    """A PIL image -> the bicubic resize to :func:`resize_dims`."""
    from PIL import Image

    w, h = img.size
    rw, rh = resize_dims(w, h, max_size, vae_scale * patch_size)
    return img.resize((rw, rh), resample=Image.BICUBIC)


def walk_images(root: str) -> List[str]:
    """Every image under ``root`` (by extension), sorted; raises if none."""
    paths = []
    for dirpath, _, filenames in os.walk(root):
        for f in filenames:
            if os.path.splitext(f)[1].lower() in ALLOWED_FORMAT:
                paths.append(os.path.join(dirpath, f))
    if not paths:
        raise RuntimeError(f"Cannot find any image under `{root}`")
    return sorted(paths)


def _image_to_array(img) -> np.ndarray:
    """A PIL image -> (3, H, W) float32 in [-1, 1]."""
    arr = np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
    arr = arr * 2.0 - 1.0
    return arr.transpose(2, 0, 1)


def _latent_path(img_path: str, dataset_path: str, latent_folder: str) -> str:
    rel = os.path.relpath(img_path, dataset_path)
    return os.path.join(latent_folder, os.path.splitext(rel)[0] + ".npy")


@torch.inference_mode()
def encode_batch(vae, images: np.ndarray, generator: Optional[torch.Generator] = None,
                 sample_posterior: bool = True) -> np.ndarray:
    """(N, 3, H, W) float32 images in [-1, 1] -> (N, latent, H/8, W/8)
    scaled latents as float32 on the host: a draw of the posterior (noise
    from ``generator``), or its mean unless ``sample_posterior``."""
    x = torch.from_numpy(np.ascontiguousarray(images)).to(vae.device)
    z = vae.encode(x, generator) if sample_posterior else vae.encode_mode(x)
    return z.float().cpu().numpy()


def preprocess_folder(
    dataset_path: str,
    latent_folder: str,
    vae,
    *,
    max_size: int = 256,
    vae_scale: int = 8,
    patch_size: int = 2,
    seed: int = 0,
    sample_posterior: bool = True,
    batch_size: int = 8,
    progress: bool = True,
) -> List[str]:
    """Encode every image under ``dataset_path`` with ``vae`` (a
    ``fit_tpu_torch.vae.AutoencoderKL``) into ``latent_folder``; returns
    the paths written. Needs PIL."""
    from PIL import Image

    paths = walk_images(dataset_path)
    written: List[str] = []
    manifest: List[str] = []
    generator = torch.Generator(vae.device).manual_seed(seed)

    # group by rounded target shape, so that each batch is one shape
    by_shape = {}
    for p in paths:
        out_path = _latent_path(p, dataset_path, latent_folder)
        manifest.append(out_path)
        if os.path.exists(out_path):
            continue
        with Image.open(p) as f:
            w, h = f.size
        by_shape.setdefault(resize_dims(w, h, max_size, vae_scale * patch_size), []).append(p)

    total = sum(len(v) for v in by_shape.values())
    done = 0
    for shape, group in sorted(by_shape.items()):
        for start in range(0, len(group), batch_size):
            chunk = group[start : start + batch_size]
            imgs = []
            for p in chunk:
                with Image.open(p) as f:
                    imgs.append(_image_to_array(resize_by_max_value(f, max_size, vae_scale, patch_size)))
            latents = encode_batch(vae, np.stack(imgs), generator, sample_posterior)
            for p, lat in zip(chunk, latents):
                out_path = _latent_path(p, dataset_path, latent_folder)
                os.makedirs(os.path.dirname(out_path), exist_ok=True)
                np.save(out_path, lat.astype(np.float16))
                written.append(out_path)
            done += len(chunk)
            if progress:
                print(f"[preprocess] {done}/{total} shape={shape}", flush=True)

    os.makedirs(latent_folder, exist_ok=True)
    with open(os.path.join(latent_folder, "path.json"), "w") as f:
        json.dump(manifest, f)
    return written
