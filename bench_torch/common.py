"""What the drivers share: building the program's models with seeded
weights, the relative gap of two tensors, and freeing the card."""

from __future__ import annotations

import gc
from typing import Dict

import numpy as np

from bench_torch import weights

def torch_dtype(name: str):
    import torch

    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def fit_kwargs(m: dict) -> dict:
    """The program's ``FiT`` arguments of a configuration's ``model``."""
    return dict(
        patch_size=m["patch_size"], in_channels=m["in_channels"], hidden_size=m["hidden_size"],
        depth=m["depth"], num_heads=m["num_heads"], mlp_ratio=m["mlp_ratio"],
        class_dropout_prob=m["class_dropout_prob"], num_classes=m["num_classes"],
        learn_sigma=m.get("learn_sigma", False),
    )


def fit_weights(run, device) -> Dict[str, "object"]:
    """The denoiser's fp32 weights of this run's seed."""
    m = run.config["model"]
    return weights.make(weights.fit_spec(m), weights.fit_init, weights.derive(run.seed, "fit"), device)


def build_fit(run, device):
    """The program's ``FiT`` at the configuration's widths, its parameters
    made on ``device`` from the seed (no per-leaf init)."""
    from fit_tpu_torch.models.fit import FiT

    m = run.config["model"]
    model = FiT(**fit_kwargs(m), dtype=torch_dtype(m["dtype"]), device="meta")
    model.to_empty(device=device)
    w = fit_weights(run, device)
    weights.load_into(model, w)
    del w
    return model


def vae_weights(run, device):
    v = run.config["vae"]
    return weights.make(weights.vae_decoder_spec(v), weights.vae_init, weights.derive(run.seed, "vae"), device)


def build_vae(run, device):
    """The program's ``AutoencoderKL`` with the seeded decoder (the encoder,
    which serving never runs, is zeroed)."""
    import torch
    from fit_tpu_torch.vae.model import AutoencoderKL

    v = run.config["vae"]
    vae = AutoencoderKL(v["block_out_channels"], v["latent_channels"], dtype=torch_dtype(v["dtype"]), device="meta")
    vae.to_empty(device=device)
    torch._foreach_zero_([p.data for p in vae.encoder.parameters()])
    w = vae_weights(run, device)
    weights.load_into(vae, w)
    del w
    return vae


def rel_gap(a, b) -> float:
    """``||a - b|| / ||b||`` in fp64 on the host."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def free_card() -> None:
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def reference_mode() -> None:
    """fp32 matmuls without TF32, for the plain reference."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
