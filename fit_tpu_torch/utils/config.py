"""Training and sampling configurations with ``fit_tpu``'s field and flag names.

Counterpart of ``TrainConfig``, ``SampleConfig``, ``add_dataclass_args`` and
``from_args`` of ``fit_tpu/utils/config.py``: dataclasses whose fields load
from JSON and are exposed as argparse flags (``--model``,
``--global-batch-size``, ...).
The parallelism fields (tp, fsdp, sp, pp, ep) and the MoE FFN's are kept
so that a ``fit_tpu`` config loads as it is; the port's Trainer raises on
the ones it does not run. ``PreprocessConfig`` is what
``fit_tpu_torch.cli.preprocess`` reads.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional, Tuple

__all__ = ["TrainConfig", "SampleConfig", "PreprocessConfig", "add_dataclass_args", "from_args"]


@dataclasses.dataclass
class TrainConfig:
    feature_path: str = "features"
    feature_val_path: str = "features_val"
    results_dir: str = "results"
    model: str = "FiT-B/2"
    image_size: int = 256
    num_classes: int = 1000
    epochs: int = 1400
    # stop after this many optimizer steps regardless of epochs (0 = no cap)
    max_steps: int = 0
    global_batch_size: int = 256
    global_seed: int = 0
    num_workers: int = 4  # loader prefetch threads
    log_every: int = 100
    ckpt_every_epochs: int = 1
    # None: resume from the latest checkpoint in results_dir if there is one;
    # "none": start afresh
    resume_from_checkpoint: Optional[str] = None
    wandb_run_id: Optional[str] = None
    use_wandb: bool = False
    # optimization (reference values)
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    ema_decay: float = 0.9999
    grad_accum: int = 2
    compute_dtype: str = "bfloat16"
    # "float32", or "bfloat16": Adam moments and the EMA shadow stored in bf16
    # with stochastic rounding (train/state.py)
    optimizer_state_dtype: str = "float32"
    # data geometry
    patch_size: int = 2
    vae_scale: int = 8
    channels: int = 4
    # packing: "pad" (FiT) or "bucket" (masked_FiT)
    packing: str = "pad"
    # "uniform" or "loss-second-moment"
    timestep_sampler: str = "uniform"
    token_buckets: Tuple[int, ...] = (32, 64, 96, 128, 192, 256)
    # parallelism (fit_tpu's; the port's Trainer runs tp = sp = pp = ep = 1, no fsdp)
    tp: int = 1
    fsdp: bool = False
    sp: int = 1
    pp: int = 1
    pp_microbatches: int = 0
    # FFN flavor: "swiglu" or "mlp" ("moe" is not ported)
    ffn: str = "swiglu"
    moe_experts: int = 8
    moe_capacity: float = 1.25
    moe_aux_weight: float = 0.01
    moe_router_jitter: float = 0.0
    ep: int = 1
    allow_batch_replication: bool = False
    # "auto" or "fused": the CUDA attention kernels on the card
    attn_backend: str = "auto"
    # recompute each block in the backward: None = on for pad packing, off
    # for token buckets
    remat: Optional[bool] = None
    # the layout of a fit_tpu checkpoint only; the port's model is the same either way
    scan_blocks: bool = True
    profile_dir: str = ""  # a torch.profiler trace of steps 10-20 goes here


@dataclasses.dataclass
class SampleConfig:
    """What the sample, demo, quantize and serve command lines read.
    ``fit_tpu``'s fields less the TPU-only ``attn_backend`` and
    ``scan_blocks``; a ``config.json`` of ``fit_tpu`` or of the Trainer
    loads as it is (unknown keys are dropped)."""

    checkpoint_path: str = ""
    num_samples: int = 4
    num_sampling_steps: int = 250
    image_height: int = 256
    image_width: int = 256
    num_classes: int = 1000
    cfg_scale: float = 1.5
    model: str = "FiT-B/2"
    sampler: str = "ddim"  # "ddim" | "ddpm" | "dpm"
    dtype: str = "bfloat16"  # or "float32"
    # packed mixed-resolution sampling: a comma-separated HxW list, e.g.
    # "256x256,224x288"; sizes cycle across samples
    image_sizes: str = ""
    batch_size: int = 100
    output_dir: str = "samples"
    global_seed: int = 0
    use_ema: bool = True
    # the training FFN flavor ("swiglu" | "mlp"); "moe" and its two fields
    # are kept for fit_tpu's flags, and building the model raises on it
    ffn: str = "swiglu"
    moe_experts: int = 8
    moe_capacity: float = 1.25
    # a --vae-checkpoint directory holds sd-vae-ft-{vae}.bin: "ema" or "mse"
    vae: str = "ema"


@dataclasses.dataclass
class PreprocessConfig:
    """``fit_tpu``'s preprocessing fields and defaults: the image tree, the
    latent tree, the encode batch, the area cap and patch size that round
    each image's size, and the VAE checkpoint (a file, or a directory
    resolved by ``vae``)."""

    dataset_path: str = "../dataset"
    latent_folder: str = "../latent"
    batch_size: int = 1
    sample_size: int = 256
    patch_size: int = 2
    vae: str = "ema"
    vae_checkpoint: Optional[str] = None


def add_dataclass_args(parser: argparse.ArgumentParser, cls) -> None:
    """Expose every field as ``--field-name``. Argparse defaults are None so
    :func:`from_args` overrides JSON values only with flags actually given."""
    for f in dataclasses.fields(cls):
        name = f.name.replace("_", "-")
        default = f.default
        if "bool" in str(f.type) or isinstance(default, bool):
            parser.add_argument(f"--{name}", type=lambda s: s.lower() in ("1", "true", "yes"), default=None)
        elif isinstance(default, tuple):
            parser.add_argument(f"--{name}", type=int, nargs="*", default=None)
        else:
            typ = type(default) if default is not None else str
            parser.add_argument(f"--{name}", type=typ, default=None)


def from_args(cls, args: argparse.Namespace, json_path: Optional[str] = None):
    """A config from an optional JSON file, overridden by the flags given."""
    base = {}
    if json_path:
        with open(json_path) as f:
            base = json.load(f)
    names = {f.name for f in dataclasses.fields(cls)}
    for k, v in vars(args).items():
        key = k.replace("-", "_")
        if key in names and v is not None:
            base[key] = tuple(v) if isinstance(v, list) else v
    return cls(**{k: v for k, v in base.items() if k in names})
