"""Where a training step's time goes on the card.

    python -m fit_tpu_torch.cli.profile_train [--model FiT-B/2] [--batch 128]
        [--grad-accum 2] [--no-remat] [--steps 3] [--dtype bfloat16|float32]
        [--trace out.json]

Builds the model in ``--dtype`` (bf16 by default; float32 is the
reference's 32-true precision, with TF32 off for the GEMMs), its AdamW
state and one synthetic batch of 256² latents
(four aspect ratios, T = 256) on
the card and runs the train step of ``fit_tpu_torch.train.step`` (with
per-block remat, as the Trainer runs pad packing, unless ``--no-remat``): two
warm-up steps, ``--steps`` steps timed on the host clock (ending in a
synchronize), then ``--steps`` more under ``torch.profiler``, whose own
overhead slows the host, so it gives only the device side. Prints the
time per optimizer step, the host's enqueue time, the device's kernel time
per step by group (GEMMs, the attention forward K1, the backward K2, the
optimizer and EMA, the rest) and K2's by kernel (the prologue, the dk/dv
and dq passes: ``mma`` in bf16, ``tf32`` in fp32), the device's idle share
(1 - kernel time over step time) and the peak memory. The data loader is
not in the window: this times the step alone.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import time

import numpy as np
import torch

from fit_tpu_torch.core.pos_embed import rope_freqs_2d
from fit_tpu_torch.diffusion.gaussian import create_diffusion
from fit_tpu_torch.models.fit import create_fit
from fit_tpu_torch.train.state import create_train_state, make_optimizer
from fit_tpu_torch.train.step import make_train_step, split_for_accumulation

LATENTS = [(32, 32), (28, 36), (24, 40), (36, 28)]  # (h, w) of the 4-channel latents
# K2's kernels: the prologue, then the dk/dv and dq passes on mma.sync (bf16)
# or on 3xTF32 mma.sync (fp32); and the fp32 FMA kernels of trees before them
# (delta and two passes)
K2_KERNELS = ("bwd_prologue_kernel", "bwd_dkdv_mma_kernel", "bwd_dq_mma_kernel", "bwd_dkdv_tf32_kernel",
              "bwd_dq_tf32_kernel", "dkdv_kernel", "dq_kernel", "delta_kernel")
GROUPS = [  # (group, substrings of the kernel names in it), first match wins
    # K1: the bf16 K pre-pass and wgmma forward (rope_attention_kernel_*), its key loop over keys of their own
    # (cross_attention_kernel_sm90) and the fp32 (3xTF32) forward
    ("K1 attention forward", ("rope_attention_tf32_kernel", "rope_attention_kernel", "cross_attention_kernel")),
    ("K2 attention backward", K2_KERNELS),
    ("GEMM", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
    ("optimizer + EMA", ("multi_tensor", "foreach", "adam")),
    ("adaLN rows (K3 int8, K5)", ("adaln_warp_rows", "adaln_block_rows")),
    ("SwiGLU rows (K4 int8, K6)", ("silu_mul_rows",)),
]


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other (elementwise, reductions, copies)"


def k2_pass(name: str) -> str:
    """The K2 kernel a device activity of K2's group belongs to."""
    for key in K2_KERNELS:
        if key in name:
            return key
    raise ValueError(f"{name} is not a K2 kernel")


def synthetic_batch(model, batch: int, generator: torch.Generator) -> dict:
    """Tokens, RoPE tables and prefix masks of ``batch`` latents at T = 256."""
    t, p = 256, model.patch_size
    pos = np.zeros((batch, t, model.head_dim), np.float32)
    mask = np.zeros((batch, t), bool)
    for i in range(batch):
        h, w = LATENTS[i % len(LATENTS)]
        tab = rope_freqs_2d(model.head_dim, h // p, w // p)
        pos[i, : len(tab)], mask[i, : len(tab)] = tab, True
    dev = "cuda"
    mask_t = torch.from_numpy(mask).to(dev)
    return {
        "tokens": torch.randn((batch, t, p * p * model.in_channels), generator=generator, device=dev) * mask_t[..., None],
        "pos": torch.from_numpy(pos).to(dev),
        "mask": mask_t,
        "lengths": torch.from_numpy(mask.sum(-1).astype(np.int32)).to(dev),
        "label": torch.randint(0, model.num_classes, (batch,), generator=generator, device=dev),
    }


def profile_step(model_name: str = "FiT-B/2", batch_size: int = 128, grad_accum: int = 2, remat: bool = True,
                 steps: int = 3, dtype: torch.dtype = torch.bfloat16, trace: str = "") -> dict:
    """Times and profiles the train step on the card (see the module's
    docstring); returns the numbers it prints."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(0)
    model = create_fit(model_name, dtype=dtype, remat=remat, generator=gen)
    state = create_train_state(model, make_optimizer(model.parameters()))
    batch = synthetic_batch(model, batch_size, gen)
    if grad_accum > 1:
        batch = split_for_accumulation(batch, grad_accum)
    step = make_train_step(create_diffusion(None), grad_accum=grad_accum)

    for _ in range(2):
        step(state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(state, batch, gen)
    enqueued = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            step(state, batch, gen)
        torch.cuda.synchronize()
    if trace:
        prof.export_chrome_trace(trace)

    by_group = collections.Counter()
    by_kernel = collections.Counter()
    k2_by_pass = collections.Counter()  # K2's group by kernel: its passes sum to the group
    k2_launches = collections.Counter()
    launches = 0
    for evt in prof.events():  # device activities only: kernels, memsets, copies
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = evt.time_range.elapsed_us()
            by_group[group_of(evt.name)] += us
            by_kernel[evt.name] += us
            if group_of(evt.name) == "K2 attention backward":
                k2_by_pass[k2_pass(evt.name)] += us
                k2_launches[k2_pass(evt.name)] += 1
            launches += 1
    device_ms = sum(by_group.values()) / 1e3 / steps
    step_ms = wall * 1e3 / steps
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    return {
        "device": smi,
        "model": model_name,
        "dtype": str(dtype).removeprefix("torch."),
        "global_batch": batch_size,
        "grad_accum": grad_accum,
        "remat": remat,
        "step_ms": step_ms,
        "host_enqueue_ms": enqueued * 1e3 / steps,
        "img_per_s": batch_size / (step_ms / 1e3),
        "device_ms_per_step": device_ms,
        "device_idle_share": max(0.0, 1.0 - device_ms / step_ms),
        "device_activities_per_step": launches / steps,
        "device_ms_by_group": {g: us / 1e3 / steps for g, us in by_group.most_common()},
        "k2_ms_by_pass": {k: us / 1e3 / steps for k, us in k2_by_pass.most_common()},
        "k2_launches_per_step": {k: n / steps for k, n in k2_launches.most_common()},
        "top_kernels_ms": {k[:90]: us / 1e3 / steps for k, us in by_kernel.most_common(12)},
        "max_memory_allocated_gib": peak / 2**30,
    }


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", default="FiT-B/2")
    parser.add_argument("--batch", type=int, default=128, help="global batch (all micro-batches)")
    parser.add_argument("--grad-accum", type=int, default=2)
    parser.add_argument("--no-remat", action="store_true", help="keep every block's activations")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                        help="the model's compute dtype (float32: TF32 off)")
    parser.add_argument("--trace", default="", help="write the chrome trace here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA card")
    result = profile_step(args.model, args.batch, args.grad_accum, not args.no_remat, args.steps,
                          getattr(torch, args.dtype), args.trace)
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
