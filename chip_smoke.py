#!/usr/bin/env python3
"""Smoke run of the PyTorch port (fit_tpu_torch) on one CUDA card.

Run from the root of the repository, on a machine with an NVIDIA Hopper
card and the CUDA toolkit:

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises (non-zero exit):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compiles the CUDA kernels from the sources in the checkout, one
     nvcc per source, all at once, and prints ptxas's registers and spill
     bytes of each K1 instantiation (bf16 mma.sync, fp32 3xTF32
     mma.sync), of each K2 pass (dk/dv, dq; bf16 mma.sync and fp32 3xTF32
     mma.sync) and of each instantiation of K3's warp-per-row kernel
     (adaln_warp_rows, every width to 1152); a K1 or K2 one that spills at
     DP 64 or 80, a K3 one that spills, or a missing instantiation fails
     the run;
  3. kernel vs plain: the RoPE + masked attention kernel against its plain
     PyTorch version at the shapes of the main path, with the time of both;
  3b. the row kernels (adaLN and SwiGLU glue, with and without the int8
     epilogue) against their plain versions at FiT-XL/2 serving shapes,
     with the time of both, the bound and the kernel's share of it (and
     K3's predecessor's time), and the int8 GEMM
     (torch._int_mm) beside bf16;
  4. sampling: FiT-XL/2 with seeded random weights, 256x256 DDIM + CFG
     ``FiTSampler.sample`` at batch 8 and ``sample_mixed`` over four aspect
     ratios, checking the outputs, the kernel's launch count and one guided
     forward against the same forward with the plain kernels;
  5. int8 serving: the same weights through ``quantize_model``; one guided
     int8 forward against the plain kernels and against the bf16 model,
     and one under ``torch.profiler`` (device time by group, and K3's
     total over its 56 launches); then ``SamplingServer`` behind its HTTP handler on 127.0.0.1 answers
     seeded requests of mixed sizes, checking every response, the
     determinism of a repeated seed, the server's stats and every kernel's
     launch count;
  6. training: K1's lse output and the backward K2 against their plain
     versions (and K2 against autograd through the plain forward) from the
     FiT-B/2 micro-batch to XL at T 4096, with the kernel, plain and SDPA
     times and the bound, the bf16 and the fp32 K2's time beside their
     predecessors' and, at B/2 and T 4096, each of their passes alone
     (prologue, dk/dv, dq; a whole call repeated pass by pass must give
     the same bits), the fp32 one beside SDPA's fp32 backward and both
     bounds; one FiT-B/2 training step, bf16 and fp32, through the
     kernels against the same step through their plain versions; then the
     Trainer on synthetic latents: a 6-step pad-packed run, the same run
     stopped at step 4 and resumed by a fresh Trainer (the loss stream must
     repeat), 3 steps of bucket packing and 3 pad-packed steps in fp32
     (``compute_dtype="float32"``, TF32 off), each run's launches asserted;
  7. DiT: K1's two new modes against their plain versions, with the
     kernel, plain and SDPA times and the bound: RoPE off through
     ``masked_attention`` on (B, H, T, d) views of a packed projection (the
     DiT-XL/2 512^2 shape, B 16 T 1024, full and padded lengths, and d 64
     T 256), and RoPE on through ``rope_flash_attention`` on (B, T, H, d)
     tensors and views (XL B16 T256); then DiT-XL/2 with seeded random
     weights samples 512x512 (DDPM, LEARNED_RANGE, 10 steps, CFG 4.0,
     batch 8), checking the output, every launch count and one guided
     forward against the plain kernels, with one step's host and device
     time by group; then one guided FiT-XL/2 forward with
     ``pos_kind="absolute"`` and ``ffn="mlp"`` over mixed sizes (prefix
     masks), kernels vs plain. 7d: K7 (the sparse-MoE combine) and K6 on
     the ``[gate | up]`` halves against their plain versions at the
     DiT-MoE-G/2 cell's shapes (16,384 tokens, k 2, and 32,768 routed rows of
     5632), with the kernel and plain times and the bound; then
     DiT-MoE-G/2-16E2A's first two blocks at full width sample 256x256 (DDIM
     5 steps, CFG 1.5, batch 32) after one guided forward against the plain
     kernels, checking the output and every launch count, the grouped
     GEMMs' included. Then the bf16 and the fp32 K1's device time
     at the three main-path shapes (phases 3, 6a and 7a) beside their
     predecessors', the bound (fp32: on the 3xTF32 basis, the FMA rate's
     beside it), the plain version and SDPA;
  8. the command line, on phase 4's FiT-XL/2 weights at full depth: a
     reference (PyTorch Lightning) checkpoint with an EMA copy in its
     optimizer state is written under build/ (and deleted at the end);
     ``cli.sample`` samples its EMA with DPM-Solver++ (bit-identical to
     ``FiTSampler`` on the same weights, labels and generator), DDIM, DDIM
     packed over four sizes and DDIM in fp32, beside which one guided fp32
     forward is profiled (device ms of K1, the GEMMs and the rest);
     ``cli.quantize`` writes int8
     artifacts without and with SmoothQuant on 2 batches, whose forward is
     checked against the plain kernels (and the equalized bf16 model
     against the unequalized one); ``cli.sample`` samples the artifact;
     ``python -m fit_tpu_torch.cli.serve`` serves it on 127.0.0.1 (12
     requests, a repeated seed bit-identical) and exits 0 on SIGINT. Then
     the pixels: a seeded full-width SD-VAE written as two diffusers .bin
     files (Linear and 1x1-conv mid-block attention, the same weights);
     ``cli.sample --vae-checkpoint`` (dpm batch 8: PNGs within one uint8
     step of the direct decode of the latents the same seed wrote without
     the flag; packed over four sizes, each PNG at its size); ``cli.demo``
     on the int8 artifact (a 512 x 1024 grid); ``cli.serve
     --vae-checkpoint`` as a process (12 requests, every body an image/png
     of its size, a repeated seed bit-identical, exit 0 on SIGINT); and
     ``cli.preprocess`` as a process over a small image tree. Every CLI
     run's launch counts are asserted (the serving processes print theirs);
  9. pixels: the same SD-VAE at full width decodes phase 4's FiT-XL/2
     latents (batch 8 at 256^2, and the four sizes one decode per shape)
     and phase 7's DiT-XL/2 512^2 latents in bf16 and fp32 (bf16 within
     5e-2 relative RMS of fp32; ms per batch, img/s, TFLOP/s, the bound,
     peak memory); encodes 64 synthetic images of four aspect ratios in
     fp32 through ``preprocess_folder`` (latents of resize_dims / 8, a
     rerun writes nothing, bf16 encode within 5e-2 of fp32, ms per image);
     the Trainer takes 2 FiT-B/2 steps on exactly those latents (global
     batch 32 = 2 x 16, a cut), 3 steps with ``ffn="mlp"`` at global batch
     128 on phase 6's synthetic latents (ms/step), each run's launches
     asserted; and one FiT-B/2 learn_sigma loss (RESCALED_MSE: mse + vb)
     forward and backward through the kernels against their plain
     versions at phase 6's bars;
  10. eval: ``python -m fit_tpu_torch.cli.sample --vae-checkpoint`` (a
     process) samples 64 PNGs at 256^2 with DPM-Solver++ from phase 8's
     FiT-XL/2 checkpoint and SD-VAE (K1's launches asserted, the ``eval``
     path); ``python -m fit_tpu_torch.cli.fid`` (processes) writes the
     statistics of 64 synthetic reference images with a seeded full-width
     InceptionV3 (pytorch-fid's names, 1008-way fc) and prints FID, sFID,
     IS and Precision/Recall of the samples against them (finite numbers
     checked); the card's pool3, spatial and probs against the CPU's at
     256^2 and 512^2 (1e-4 of max |CPU|, TF32 off); feature img/s at batch
     64 beside the fp32 bound and the feature time of a 50k-image FID; the
     MFU of phase 4's sampling step and phase 6's optimizer step
     (``utils/flops.py``; model FLOPs, 3 x the forward for a training
     step, with the HFU that also counts remat's second forward beside
     it); and the native packer's batches/s against the numpy loader's on
     phase 6's latents (the same bytes; median and spread of 3 runs).
The line before the last is a JSON object with each kernel's numbers
(launches by path: sample, serve, train, dit, ditmoe, cli, pixels, eval; an entry's
"fp32" numbers carry their own launches); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import gc
import io
import json
import os
import queue
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

from fit_tpu_torch.utils.flops import peak_flops, peak_hbm_bw

STEPS = 10
CFG_SCALE = 1.5
BATCH = 8
MIXED_SIZES = [(256, 256), (224, 288), (192, 320), (256, 224)]
DEPTH = 28  # FiT-XL/2 blocks, one kernel launch each per denoise step
BF16_ATOL = 3e-2  # bf16 q/k, p and output roundings against the fp32 plain version
FP32_ATOL = 1e-4  # K1 and K2: 3xTF32 products, another summation order
FORWARD_REL_RMS = 5e-2  # a full bf16 XL forward, kernel vs plain attention
# One int8 FiT-XL/2 block (fp32 compute), kernels vs plain kernels, on the
# block's update: 1e-2 relative RMS. The int8 path is not a smooth function
# of its input: a sum taken in another order that tips a value across a
# rounding boundary moves it by a whole int8 step. So the script also
# measures that floor, the plain path's own move under a relative input
# perturbation of 1e-7 (one block) and 1e-6 (the whole forward). Over 28
# blocks the steps add up to about the quantization error itself, so the
# whole int8 forward is held to FORWARD_REL_RMS, as the bf16 one is.
INT8_BLOCK_REL_RMS = 1e-2
BLOCK_PERTURBATION = 1e-7
INPUT_PERTURBATION = 1e-6
SERVE_STEPS = 10
SERVE_BATCH = 8
SEED_REPEAT_ATOL = 1e-3  # bound on a repeated seed's drift, should the bits differ
XL_HIDDEN = 1152


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_case(ra, rope_freqs_2d, h, d, t, lengths, dtype, seed, yardstick=False):
    """Kernel vs plain on one shape: (max abs err on valid rows, kernel ms,
    plain ms), and with ``yardstick`` a dict of the device times of the
    kernel, its plain version and SDPA's forward, and the bound."""
    b = len(lengths)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, t, 3 * h * d), generator=gen, device="cuda").to(dtype)
    side = int(t**0.5)
    fc = torch.from_numpy(rope_freqs_2d(d, side, side)).float().cuda()
    cos, sin = (x.expand(b, t, d).contiguous() for x in ra.split_rope_tables(fc))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    scale = d**-0.5
    got = ra.qkv_rope_attention(qkv, cos, sin, lens, scale, h)
    torch.cuda.synchronize()
    want = ra.rope_attention_reference(qkv.float(), cos, sin, lens, scale, h)
    if not torch.isfinite(got).all():
        raise AssertionError(f"non-finite kernel output at {(b, t, h, d, dtype)}")
    err = max((got[i, :n].float() - want[i, :n]).abs().max().item() for i, n in enumerate(lengths))
    ms = time_ms(lambda: ra.qkv_rope_attention(qkv, cos, sin, lens, scale, h, check_lengths=False))
    plain_ms = time_ms(lambda: ra.rope_attention_reference(qkv, cos, sin, lens, scale, h))
    tol = BF16_ATOL if dtype == torch.bfloat16 else FP32_ATOL
    print(
        f"kernel vs plain: B={b} T={t} H={h} d={d} {str(dtype).removeprefix('torch.')} "
        f"max_abs_err={err:.3e} (tol {tol:g}) kernel_us={ms * 1e3:.1f} plain_us={plain_ms * 1e3:.1f}",
        flush=True,
    )
    if not err <= tol:
        raise AssertionError(f"kernel disagrees with the plain version: {err} > {tol}")
    if not yardstick:
        return err, ms, plain_ms
    (bound, by), _ = attention_bounds(b, t, h, d, lengths, dtype, with_lse=False)
    (fma_bound, fma_by), _ = attention_bounds(b, t, h, d, lengths, dtype, with_lse=False, peak=FP32_FMA_FLOPS)
    dev = {
        "ms": device_ms(lambda: ra.qkv_rope_attention(qkv, cos, sin, lens, scale, h, check_lengths=False)),
        "plain_ms": device_ms(lambda: ra.rope_attention_reference(qkv, cos, sin, lens, scale, h), iters=5),
        "library_ms": sdpa_ms(ra, qkv, cos, sin, lens, h, with_bwd=False)[0],
        "bound_ms": bound,
        "bound_by": by,
        "fma_bound_ms": fma_bound,
    }
    fma = f" (at the fp32 FMA rate {fma_bound * 1e3:.1f} by {fma_by})" if dtype == torch.float32 else ""
    print(
        f"kernel vs plain, device times (launches queued behind a spin kernel): kernel_us={dev['ms'] * 1e3:.1f} "
        f"plain_us={dev['plain_ms'] * 1e3:.1f} SDPA_fwd_us={dev['library_ms'] * 1e3:.1f} (excludes RoPE) "
        f"bound_us={bound * 1e3:.1f} by {by}{fma} {str(dtype).removeprefix('torch.')}",
        flush=True,
    )
    return err, ms, plain_ms, dev


# Bounds divide by the H100 SXM's data-sheet peaks in utils/flops.py:
# dense bf16 tensor cores; fp32-accurate products as three TF32 products
# (3xTF32, the fp32 K1's scheme) at the TF32 rate. The fp32 FMA rate, the
# basis before it, is printed beside every fp32 attention bound.
H100 = "NVIDIA H100 80GB HBM3"
HBM_BYTES_PER_S = peak_hbm_bw(H100)
PEAK_FLOPS = {torch.bfloat16: peak_flops(H100, "bfloat16"), torch.float32: peak_flops(H100, "tf32") / 3}
FP32_FMA_FLOPS = peak_flops(H100, "float32")
# K2 against its plain version, per tensor dq / dk / dv: max abs error over
# max |plain| in bf16 (bf16 rounding of the rotated q/k, of p, of ds and of
# the stored gradient), and over max(1, max |plain|) in fp32.
GRAD_REL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
# (H, d, B, T, lengths): FiT-B/2 training micro-batch (the main shape), the
# small token buckets, and XL's d = 72 from 256^2 to 1024^2; the T 4096 row
# leaves its last 64-key tile empty, and length 1 is a row of one key.
GRAD_SHAPES = [
    (12, 64, 64, 256, [256, 200, 130, 64, 1, 255, 129, 33] * 8),
    (12, 64, 16, 96, [96, 50, 1, 95] * 4),
    (12, 64, 16, 32, [32, 17, 1, 31] * 4),
    (16, 72, 16, 256, [256, 256, 200, 130, 64, 1, 255, 129] * 2),
    (16, 72, 4, 1024, [1024, 700, 1, 1000]),
    (16, 72, 2, 2304, [2304, 1500]),
    (16, 72, 1, 4096, [4000]),
]


# The bf16 K1 (mma.sync, rope_attention_mma.cuh) at the three main-path
# shapes, with its predecessor's device us there (the WMMA kernel with
# scores in shared memory, timed by this script on an H100 80GB HBM3 at
# 700 W; PERF.md section 6).
K1_EARLIER_US = {
    "DiT-XL/2 512^2 B16 T1024 H16 d72 RoPE off": 1420.3,
    "FiT-XL/2 B16 T256 H16 d72 RoPE, mixed lengths": 115.4,
    "FiT-B/2 B64 T256 H12 d64 RoPE + lse": 209.4,
}
# The fp32 K1 (3xTF32 mma.sync, rope_attention_tf32.cuh) at the same three
# shapes, with its predecessor's device us there (the FMA kernel with scores
# and output in shared memory, timed on an H100 80GB HBM3 at 700 W against
# the parent tree by ``python -m fit_tpu_torch.cli.k1_fp32_ab --baseline``;
# PERF.md section 6).
FP32_K1_EARLIER_US = {
    "DiT-XL/2 512^2 B16 T1024 H16 d72 RoPE off": 12372.9,
    "FiT-XL/2 B16 T256 H16 d72 RoPE, mixed lengths": 722.8,
    "FiT-B/2 B64 T256 H12 d64 RoPE + lse": 1283.4,
}
NO_SPILL_DPS = (64, 80)  # the main paths' paddings: their K1 and K2 (bf16, fp32) must not spill
# K3 at the row kernels' shapes (rows (B, T) of width 1152), with its
# predecessor's device us there (one block of 128 threads per row, timed
# by this script on an H100 80GB HBM3 at 700 W; PERF.md section 6).
K3_EARLIER_US = {(16, 256): 12.8, (64, 256): 47.6, (5, 251): 6.4}
# The bf16 K2 at the GRAD_SHAPES cases it was timed at before its mma.sync
# passes, with its predecessor's device us there (the WMMA kernels with
# scores and accumulators in shared memory, timed by this script on an H100
# 80GB HBM3 at 700 W; PERF.md section 6), by case index.
K2_EARLIER_US = {0: 639.6, 3: 321.9, 4: 984.9, 5: 2881.0, 6: 4916.1}
# The fp32 K2 (3xTF32 mma.sync passes, rope_attention_bwd_tf32.cuh) at the
# same cases, with its predecessor's device us there (the FMA kernels with
# scores and accumulators in shared memory, timed by this script on an
# H100 80GB HBM3 at 700 W; PERF.md section 6).
FP32_K2_EARLIER_US = {0: 5201.1, 6: 53580.6}
K2_PASS_CASES = (0, 6)  # the B/2 main shape and XL T 4096: per-pass device times
K2_PASSES = {"prologue": 1, "dkdv": 2, "dq": 4}  # the bits of rope_attention_bwd's passes


def ptxas_by_kernel(log_text: str, pattern: str) -> "dict[tuple, dict]":
    """ptxas -v of the kernel instantiations in one build log whose mangled
    name matches ``pattern``, keyed by its groups: registers and spill
    store / load bytes."""
    out, key = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            inst = re.search(pattern, m.group(1))
            key = inst.groups() if inst else None
            if key:
                out[key] = {}
        elif key and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[key]["spill_stores"], out[key]["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif key and (m := re.search(r"Used (\d+) registers", line)):
            out[key]["registers"] = int(m.group(1))
    return out


def mma_ptxas(log_text: str) -> "dict[tuple[int, bool], dict]":
    """The bf16 K1 instantiations, by (DP, RoPE)."""
    found = ptxas_by_kernel(log_text, r"rope_attention_mma_kernelILi(\d+)ELb([01])E")
    return {(int(dp), rope == "1"): info for (dp, rope), info in found.items()}


def tf32_ptxas(log_text: str) -> "dict[tuple[int, bool], dict]":
    """The fp32 K1 (3xTF32) instantiations, by (DP, RoPE)."""
    found = ptxas_by_kernel(log_text, r"rope_attention_tf32_kernelILi(\d+)ELb([01])E")
    return {(int(dp), rope == "1"): info for (dp, rope), info in found.items()}


def k2_mma_ptxas(log_text: str) -> "dict[tuple[str, int], dict]":
    """The bf16 K2 passes (rope_attention_bwd_mma.cuh), by (pass, DP)."""
    found = ptxas_by_kernel(log_text, r"bwd_(dkdv|dq)_mma_kernelILi(\d+)E")
    return {(name, int(dp)): info for (name, dp), info in found.items()}


def k2_tf32_ptxas(log_text: str) -> "dict[tuple[str, int], dict]":
    """The fp32 K2 passes (rope_attention_bwd_tf32.cuh), by (pass, DP)."""
    found = ptxas_by_kernel(log_text, r"bwd_(dkdv|dq)_tf32_kernelILi(\d+)E")
    return {(name, int(dp)): info for (name, dp), info in found.items()}


def warp_rows_ptxas(log_text: str) -> "dict[tuple[str, int], dict]":
    """K3's warp-per-row instantiations, by (dtype, quads per lane)."""
    found = ptxas_by_kernel(log_text, r"adaln_warp_rowsI(13__nv_bfloat16|f)Li(\d+)E")
    return {("bf16" if t == "13__nv_bfloat16" else "fp32", int(c)): info for (t, c), info in found.items()}


def check_no_spill(what: str, found: dict, guarded, expected: int) -> None:
    """Prints each instantiation's registers and spills; fails on a spill
    in an instantiation for which ``guarded(key)`` holds (the main paths'
    shapes) or a missing instantiation."""
    for key, info in sorted(found.items()):
        print(f"build: {what} {key}: {info.get('registers')} registers, spill stores {info.get('spill_stores')} B, "
              f"spill loads {info.get('spill_loads')} B", flush=True)
    spilled = [k for k, info in found.items()
               if guarded(k) and (info.get("spill_stores"), info.get("spill_loads")) != (0, 0)]
    if len(found) != expected or spilled:
        raise AssertionError(f"{what}: {len(found)} of {expected} instantiations in the ptxas log; spills at {spilled}")


def bound_ms(nbytes: float, flops: float, dtype, peak: "float | None" = None) -> "tuple[float, str]":
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate for their type (or
    over ``peak``)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / (peak or PEAK_FLOPS[dtype])
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def attention_bounds(b, t, h, d, lengths, dtype, with_lse=True, peak=None):
    """(K1, K2) bounds for these inputs: each input read once, each output
    (K1's lse when ``with_lse``) written once; 2 products for the forward
    and 5 for the backward of 2 * T * len * d each per (row, head),
    counting only the valid keys (at ``peak`` if given)."""
    es = torch.finfo(dtype).bits // 8
    qkv, tabs, o, lse = b * t * 3 * h * d * es, 2 * b * t * d * 4, b * t * h * d * es, b * t * h * 4
    pair = sum(2 * t * n * d * h for n in lengths)
    fwd = bound_ms(qkv + tabs + 4 * b + o + (lse if with_lse else 0), 2 * pair, dtype, peak)
    bwd = bound_ms(qkv + o + o + lse + tabs + 4 * b + qkv, 5 * pair, dtype, peak)
    return fwd, bwd


def k2_pass_bounds(b, t, h, d, lengths, dtype) -> dict:
    """Each K2 pass's bound as a function of its own inputs and
    outputs: the prologue reads q, k, g, out, cos/sin and lse and writes the
    rotated q and k and the head-major lse and delta (no products); the
    dk/dv pass reads those, v, g and the tables, writes dk and dv and does 4
    products (S, dP, dv, dk) over the valid keys; the dq pass the same
    reads, writes dq and does 3 (S, dP, dq)."""
    es = torch.finfo(dtype).bits // 8
    act, tabs, stat = b * t * h * d * es, 2 * b * t * d * 4, b * t * h * 4
    pair = sum(2 * t * n * d * h for n in lengths)
    reads = 2 * act + act + act + tabs + 2 * stat + 4 * b  # rotated q, k; v; g; tables; lse, delta; lengths
    return {
        "prologue": bound_ms(4 * act + tabs + stat + 2 * act + 2 * stat, 0, dtype),
        "dkdv": bound_ms(reads + 2 * act, 4 * pair, dtype),
        "dq": bound_ms(reads + act, 3 * pair, dtype),
    }


def sdpa_ms(ra, qkv, cos, sin, lens, h, with_bwd=True):
    """The library yardstick, which excludes RoPE: F.scaled_dot_product_attention
    on pre-rotated q, k (B, H, T, d) with the boolean key mask. Returns the
    device ms of its forward and (``with_bwd``) of its backward alone."""
    b, t, w = qkv.shape
    d = w // 3 // h
    qr, kr, v = (x.to(qkv.dtype).transpose(1, 2).contiguous() for x in ra._rotated_heads(qkv, cos, sin, h))
    mask = (torch.arange(t, device=qkv.device)[None, :] < lens[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd = device_ms(lambda: sdpa(qr, kr, v, attn_mask=mask, scale=d**-0.5))
    if not with_bwd:
        return fwd, None
    qr, kr, v = (x.requires_grad_(True) for x in (qr, kr, v))
    out = sdpa(qr, kr, v, attn_mask=mask, scale=d**-0.5)
    g = torch.randn_like(out)
    bwd = device_ms(lambda: torch.autograd.grad(out, (qr, kr, v), g, retain_graph=True))
    return fwd, bwd


def attention_grad_case(ra, rope_freqs_2d, h, d, b, t, lengths, dtype, seed, per_pass=False):
    """Phase 6a on one shape: K1 with lse and K2 against their plain versions
    (and K2 against autograd through the plain forward), with device times;
    with ``per_pass``, also each K2 pass's device time alone (after a whole
    call has filled the scratch). Returns a dict of the errors, times and
    bounds."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, t, 3 * h * d), generator=gen, device="cuda").to(dtype)
    g = torch.randn((b, t, h * d), generator=gen, device="cuda").to(dtype)  # on every row, padded too
    side = int(np.ceil(t**0.5))
    fc = torch.from_numpy(rope_freqs_2d(d, side, side)[:t]).float().cuda()
    cos, sin = (x.expand(b, t, d).contiguous() for x in ra.split_rope_tables(fc))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    scale = d**-0.5
    out, lse = ra.rope_attention_fwd(qkv, cos, sin, lens, scale, h, with_lse=True)
    out_plain_kernel = ra.rope_attention_fwd(qkv, cos, sin, lens, scale, h)
    dqkv = ra.rope_attention_bwd(qkv, g, out, lse, cos, sin, lens, scale, h)
    torch.cuda.synchronize()
    if not torch.equal(out, out_plain_kernel):
        raise AssertionError(f"K1's output changes with the lse output at {(b, t, h, d, dtype)}")
    _, lse_want = ra.rope_attention_reference(qkv, cos, sin, lens, scale, h, with_lse=True)
    want = ra.rope_attention_backward_reference(qkv, g, out, lse, cos, sin, lens, scale, h).float()
    q32 = qkv.float().requires_grad_(True)
    (auto,) = torch.autograd.grad(ra.rope_attention_reference(q32, cos, sin, lens, scale, h), q32, g.float())
    got = dqkv.float()
    if not (torch.isfinite(got).all() and torch.isfinite(lse).all()):
        raise AssertionError(f"non-finite K1 lse or K2 output at {(b, t, h, d, dtype)}")
    c = h * d
    res = {"lse_err": (lse - lse_want).abs().max().item(), "max_abs_err": (got - want).abs().max().item()}
    for i, name in enumerate("qkv"):
        part, ref, ref_auto = (x[..., i * c : (i + 1) * c] for x in (got, want, auto))
        denom = ref.abs().max().item() if dtype == torch.bfloat16 else max(1.0, ref.abs().max().item())
        res[f"d{name}_rel"] = (part - ref).abs().max().item() / denom
        res[f"d{name}_auto_rel"] = (part - ref_auto).abs().max().item() / denom
    masked = sum(got[i, n:, c:].abs().sum().item() for i, n in enumerate(lengths))
    lse_tol = GRAD_REL[dtype] * max(1.0, lse_want.abs().max().item())
    res["fwd_ms"] = device_ms(lambda: ra.rope_attention_fwd(qkv, cos, sin, lens, scale, h, with_lse=True, check_lengths=False))
    res["bwd_ms"] = device_ms(lambda: ra.rope_attention_bwd(qkv, g, out, lse, cos, sin, lens, scale, h))
    if per_pass:
        by_pass, scratch = torch.empty_like(qkv), ra._k2_scratch(qkv, h)
        ra._k2_launch(qkv, g, out, lse, cos, sin, lens, scale, h, by_pass, *scratch)
        bounds = k2_pass_bounds(b, t, h, d, lengths, dtype)
        for name, bit in K2_PASSES.items():
            res[f"bwd_{name}_ms"] = device_ms(
                lambda: ra._k2_launch(qkv, g, out, lse, cos, sin, lens, scale, h, by_pass, *scratch, passes=bit)
            )
            res[f"bwd_{name}_bound_ms"], res[f"bwd_{name}_bound_by"] = bounds[name]
        torch.cuda.synchronize()
        if not torch.equal(by_pass, dqkv):
            raise AssertionError(f"K2's passes launched one by one disagree with a whole call at {(b, t, h, d, dtype)}")
    res["fwd_plain_ms"] = device_ms(lambda: ra.rope_attention_reference(qkv, cos, sin, lens, scale, h, with_lse=True), iters=5)
    res["bwd_plain_ms"] = device_ms(lambda: ra.rope_attention_backward_reference(qkv, g, out, lse, cos, sin, lens, scale, h), iters=5)
    res["sdpa_fwd_ms"], res["sdpa_bwd_ms"] = sdpa_ms(ra, qkv, cos, sin, lens, h)
    (res["fwd_bound_ms"], res["fwd_bound_by"]), (res["bwd_bound_ms"], res["bwd_bound_by"]) = attention_bounds(
        b, t, h, d, lengths, dtype
    )
    (res["fwd_fma_bound_ms"], _), (res["bwd_fma_bound_ms"], _) = attention_bounds(
        b, t, h, d, lengths, dtype, peak=FP32_FMA_FLOPS
    )
    errs = " ".join(f"{k}={v:.2e}" for k, v in res.items() if k.endswith("rel"))
    print(
        f"K1-lse/K2 vs plain: B={b} T={t} H={h} d={d} {str(dtype).removeprefix('torch.')} "
        f"lse_err={res['lse_err']:.2e} (tol {lse_tol:.2e}) {errs} (tol {GRAD_REL[dtype]:g}) "
        f"masked-key dk+dv sum={masked:g}; us: K1-lse {res['fwd_ms'] * 1e3:.1f} "
        f"(plain {res['fwd_plain_ms'] * 1e3:.1f}, SDPA fwd {res['sdpa_fwd_ms'] * 1e3:.1f}, "
        f"bound {res['fwd_bound_ms'] * 1e3:.1f} by {res['fwd_bound_by']}), K2 {res['bwd_ms'] * 1e3:.1f} "
        f"(plain {res['bwd_plain_ms'] * 1e3:.1f}, SDPA bwd {res['sdpa_bwd_ms'] * 1e3:.1f}, "
        f"bound {res['bwd_bound_ms'] * 1e3:.1f} by {res['bwd_bound_by']}); SDPA excludes RoPE"
        + (f"; fp32 bounds at the FMA rate: K1 {res['fwd_fma_bound_ms'] * 1e3:.1f}, K2 "
           f"{res['bwd_fma_bound_ms'] * 1e3:.1f}" if dtype == torch.float32 else ""),
        flush=True,
    )
    worst = max(v for k, v in res.items() if k.endswith("rel"))
    if not (worst <= GRAD_REL[dtype] and res["lse_err"] <= lse_tol and masked == 0):
        raise AssertionError(f"K1-lse or K2 disagrees with its plain version at {(b, t, h, d, dtype)}")
    return res


# 6b/6c: FiT-B/2 training at 256^2 (T = 256 at patch 2) from synthetic
# variable-aspect latents, each within the 256-token budget
TRAIN_LATENTS = [(4, 32, 32), (4, 28, 36), (4, 24, 40), (4, 36, 28)]
B2_DEPTH, TRAIN_BATCH, TRAIN_ACCUM = 12, 128, 2
# One step, kernels vs plain: (loss rel, min grad cosine, grad norm rel). In
# fp32 both runs share the fp32 GEMMs (TF32 off), so only K1 and K2 differ,
# each by ~1e-5 of its plain version.
STEP_BARS = {torch.bfloat16: (1e-2, 0.99, 5e-2), torch.float32: (1e-4, 0.9999, 1e-3)}
FP32_TRAIN_STEPS = 3
RESUME_ATOL = 1e-6  # the resumed loss stream, should its bits differ


def train_step_check(ra, rope_freqs_2d, dtype=torch.bfloat16) -> None:
    """Phase 6b: one FiT-B/2 micro-batch (64 x T 256, remat on) in ``dtype``
    through the kernels and through their plain versions, on the same random
    weights, inputs and noise: the loss, and the flat gradient's cosine and
    norm."""
    from fit_tpu_torch.diffusion.gaussian import create_diffusion
    from fit_tpu_torch.models.fit import create_fit
    from fit_tpu_torch.train.step import diffusion_loss

    gen = torch.Generator(device="cuda").manual_seed(6)
    model = create_fit("FiT-B/2", dtype=dtype, remat=True, device="cuda")
    with torch.no_grad():
        for p in model.parameters():  # the reference init zeroes adaLN and the final layer
            p.normal_(0.0, 0.02, generator=gen)
    n, t = TRAIN_BATCH // TRAIN_ACCUM, 256
    pos = torch.zeros((n, t, model.head_dim))
    mask = torch.zeros((n, t), dtype=torch.bool)
    for i in range(n):
        _, h, w = TRAIN_LATENTS[i % len(TRAIN_LATENTS)]
        tab = torch.from_numpy(rope_freqs_2d(model.head_dim, h // 2, w // 2))
        pos[i, : len(tab)], mask[i, : len(tab)] = tab, True
    mask = mask.cuda()
    batch = {
        "tokens": torch.randn((n, t, 16), generator=gen, device="cuda") * mask[..., None],
        "pos": pos.cuda(),
        "mask": mask,
        "lengths": mask.sum(-1, dtype=torch.int32),
        "label": torch.randint(0, 1000, (n,), generator=gen, device="cuda"),
        "t": torch.randint(0, 1000, (n,), generator=gen, device="cuda"),
        "noise": torch.randn((n, t, 16), generator=gen, device="cuda"),
        "drop_ids": (torch.rand((n,), generator=gen, device="cuda") < 0.1).int(),
    }
    diffusion = create_diffusion(None)

    def run(plain):
        model.plain_kernels = plain
        model.zero_grad(set_to_none=True)
        ra.reset_launches()
        loss, _ = diffusion_loss(model, diffusion, batch)
        loss.backward()
        return loss.item(), torch.cat([p.grad.flatten().float() for p in model.parameters()])

    try:
        (loss_k, g_k), launched = run(False), (ra.launches, ra.bwd_launches)
        loss_p, g_p = run(True)
    finally:
        model.plain_kernels = False
    if launched != (2 * B2_DEPTH, B2_DEPTH) or (ra.launches, ra.bwd_launches) != (0, 0):
        raise AssertionError(f"the {dtype} step launched K1, K2 {launched} times through the kernels and "
                             f"{(ra.launches, ra.bwd_launches)} through the plain versions, expected "
                             f"{(2 * B2_DEPTH, B2_DEPTH)} and (0, 0)")
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    cos = torch.nn.functional.cosine_similarity(g_k, g_p, dim=0).item()
    norm_rel = abs(g_k.norm().item() - g_p.norm().item()) / g_p.norm().item()
    loss_tol, min_cos, norm_tol = STEP_BARS[dtype]
    print(
        f"train step, kernels vs plain kernels: FiT-B/2 {str(dtype).removeprefix('torch.')} micro-batch {n} x T {t}, "
        f"remat: loss {loss_k:.6f} vs {loss_p:.6f} rel {rel_loss:.3e} (tol {loss_tol:g}); grad cosine {cos:.7f} "
        f"(min {min_cos:g}); grad norm {g_k.norm().item():.5f} vs {g_p.norm().item():.5f} rel {norm_rel:.3e} "
        f"(tol {norm_tol:g}), max |grad diff| {(g_k - g_p).abs().max().item():.3e}; launches K1 {launched[0]}, "
        f"K2 {launched[1]}",
        flush=True,
    )
    if not (rel_loss <= loss_tol and cos >= min_cos and norm_rel <= norm_tol and np.isfinite(loss_k)):
        raise AssertionError(f"the {dtype} training step through the kernels disagrees with the plain one")


def float_glue(forwards: int, depth: int = DEPTH, swiglu: bool = True) -> dict:
    """The row-glue launches of ``forwards`` float forwards on the card that
    need no backward: K5 for each block's attention LayerNorm and for the
    final layer's, K5R for each block's attention residual + FFN LayerNorm,
    K6 for each SwiGLU product (none in a GELU MLP block)."""
    return {"adaln_modulate": (depth + 1) * forwards, "adaln_residual": depth * forwards,
            "swiglu_glue": depth * forwards if swiglu else 0}


def kernel_launches(ra, quant, fused_adaln, attn) -> dict:
    """Every kernel's launch count since its module's last reset."""
    return {"rope_attention_fwd": ra.launches, "rope_attention_bwd": ra.bwd_launches,
            "rope_flash_attention": ra.flash_launches, "masked_attention": attn.launches, **quant.launches,
            **fused_adaln.launches}


def trainer_phase(kernel_modules, smi):
    """Phase 6c: the Trainer on synthetic latents, FiT-B/2, global batch 128
    in 2 micro-batches. Pad packing (remat on), bf16: a straight 6-step run
    across the epoch boundary at step 4, and the same in a fresh results
    directory as fit(4), then a fresh Trainer that resumes to step 6; then 3
    steps of bucket packing; then 3 pad-packed steps in fp32. Asserts the
    resumed loss stream and every run's launch counts; returns this path's
    launch counts, the fp32 run's K2 launches and the bf16 pad run's
    seconds per optimizer step."""
    import shutil
    from pathlib import Path

    from fit_tpu_torch.train.loop import Trainer
    from fit_tpu_torch.utils.config import TrainConfig

    work = Path("build") / "chip_smoke_train"
    shutil.rmtree(work, ignore_errors=True)
    write_train_latents(work / "latents")  # 2 classes, 4 MB of fp16 latents

    def losses(name):
        with open(work / name / "FiT-B-2_metrics.jsonl") as f:
            recs = [json.loads(line) for line in f]
        return {r["step"]: (r["train_loss"], r["time"]) for r in recs if "train_loss" in r}

    totals = {k: 0 for k in kernel_launches(*kernel_modules)}

    def run(name, max_steps, packing="pad", compute_dtype="bfloat16"):
        cfg = TrainConfig(
            feature_path=str(work / "latents"), feature_val_path="", results_dir=str(work / name),
            model="FiT-B/2", global_batch_size=TRAIN_BATCH, grad_accum=TRAIN_ACCUM, compute_dtype=compute_dtype,
            packing=packing, log_every=1, ckpt_every_epochs=100, num_workers=4,
        )
        trainer = Trainer(cfg)
        seqs = []
        step_fn = trainer.train_step
        trainer.train_step = lambda state, batch, g: seqs.append(batch["tokens"].shape[2]) or step_fn(state, batch, g)
        for mod in kernel_modules:
            mod.reset_launches()
        state = trainer.fit(max_steps=max_steps)
        torch.cuda.synchronize()
        counts = kernel_launches(*kernel_modules)
        for k, v in counts.items():
            totals[k] += v
        steps = len(seqs)
        per_step = 2 * B2_DEPTH * TRAIN_ACCUM if packing == "pad" else B2_DEPTH * TRAIN_ACCUM  # remat runs K1 twice
        want = {k: 0 for k in counts}
        want.update(rope_attention_fwd=per_step * steps, rope_attention_bwd=B2_DEPTH * TRAIN_ACCUM * steps)
        if counts != want or state.step != max_steps:
            raise AssertionError(f"trainer run {name}: step {state.step}, launches {counts}, expected {want}")
        return seqs, counts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, straight_counts = run("straight", 6)
    peak = torch.cuda.max_memory_allocated()
    want = losses("straight")
    times = [want[s][1] - want[s - 1][1] for s in range(2, 7)]
    step_s = float(np.median(times))
    _, first_counts = run("split", 4)
    _, resumed_counts = run("split", 6)
    got = losses("split")
    diffs = [abs(got[s][0] - want[s][0]) for s in range(1, 7)]
    bucket_seqs, bucket_counts = run("bucket", 3, packing="bucket")
    bucket = losses("bucket")
    # fp32 (the reference's 32-true precision): every K2 launch is the 3xTF32 K2
    torch.cuda.reset_peak_memory_stats()
    _, fp32_counts = run("fp32", FP32_TRAIN_STEPS, compute_dtype="float32")
    fp32_peak = torch.cuda.max_memory_allocated()
    fp32 = losses("fp32")
    fp32_times = [fp32[s][1] - fp32[s - 1][1] for s in range(2, FP32_TRAIN_STEPS + 1)]
    every = [v[0] for v in (*want.values(), *got.values(), *bucket.values(), *fp32.values())]
    shutil.rmtree(work, ignore_errors=True)
    print(
        f"trainer: FiT-B/2 bf16 256^2 pad packing, global batch {TRAIN_BATCH} = {TRAIN_ACCUM} x {TRAIN_BATCH // TRAIN_ACCUM}, "
        f"remat: {step_s * 1e3:.2f} ms per optimizer step (median of steps 2-6: "
        f"{', '.join(f'{x * 1e3:.2f}' for x in times)}), {TRAIN_BATCH / step_s:.2f} img/s, max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; loss {', '.join(f'{want[s][0]:.6f}' for s in range(1, 7))}; launches per run: "
        f"straight {straight_counts}, fit(4) {first_counts}, resumed to 6 {resumed_counts}",
        flush=True,
    )
    print(
        f"trainer resume: loss stream max|diff| {max(diffs):.3e} over 6 steps (bit-identical: {max(diffs) == 0.0}); "
        f"bucket packing 3 steps at T {bucket_seqs}: loss {', '.join(f'{bucket[s][0]:.6f}' for s in (1, 2, 3))}, "
        f"launches {bucket_counts}",
        flush=True,
    )
    fp32_step_s = float(np.median(fp32_times))
    print(
        f"trainer fp32: FiT-B/2 float32 (TF32 off) 256^2 pad packing, global batch {TRAIN_BATCH} = {TRAIN_ACCUM} x "
        f"{TRAIN_BATCH // TRAIN_ACCUM}, remat: {fp32_step_s * 1e3:.2f} ms per optimizer step (median of steps "
        f"2-{FP32_TRAIN_STEPS}: {', '.join(f'{x * 1e3:.2f}' for x in fp32_times)}), {TRAIN_BATCH / fp32_step_s:.2f} "
        f"img/s, max_memory_allocated {fp32_peak / 2**30:.2f} GiB; loss "
        f"{', '.join(f'{fp32[s][0]:.6f}' for s in range(1, FP32_TRAIN_STEPS + 1))}; launches {fp32_counts} "
        f"({fp32_counts['rope_attention_fwd'] // FP32_TRAIN_STEPS} K1 with lse, "
        f"{fp32_counts['rope_attention_bwd'] // FP32_TRAIN_STEPS} K2 per step); {smi}",
        flush=True,
    )
    if not (max(diffs) <= RESUME_ATOL and all(np.isfinite(every)) and set(got) == set(range(1, 7))):
        raise AssertionError("the resumed run did not reproduce the straight run's loss stream")
    if set(fp32) != set(range(1, FP32_TRAIN_STEPS + 1)):
        raise AssertionError(f"the fp32 Trainer run logged steps {sorted(fp32)}")
    return totals, fp32_counts["rope_attention_bwd"], step_s


def seeded_fit_xl(create_fit, gen):
    """FiT-XL/2 (bf16 compute) with weights drawn from ``gen``, N(0, 0.02)
    for every parameter (the reference init zeroes adaLN: its eps would be 0)."""
    model = create_fit("FiT-XL/2", dtype=torch.bfloat16, device="cuda")
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=gen)
    return model


def guided_inputs(sampler_mod, embed_dim, sizes, gen, method="rotate"):
    """Inputs of one guided forward at the given image sizes: RoPE tables
    (``embed_dim`` the head dim) or sincos tables (``method="absolute"``,
    ``embed_dim`` the hidden size)."""
    n = len(sizes)
    pos = torch.zeros((n, 256, embed_dim))
    mask = torch.zeros((n, 256), dtype=torch.bool)
    for i, (ih, iw) in enumerate(sizes):
        tab, valid_t = sampler_mod.create_pos_embed(ih // 8, iw // 8, 2, 256, embed_dim, method)
        pos[i] = torch.from_numpy(tab[0])
        mask[i, :valid_t] = True
    pos2, mask2 = torch.cat([pos, pos]).cuda(), torch.cat([mask, mask]).cuda()
    x = torch.randn((2 * n, 4, 32, 32), generator=gen, device="cuda")
    t = torch.full((2 * n,), 500, device="cuda")
    y = torch.cat([torch.arange(n, device="cuda"), torch.full((n,), 1000, device="cuda")])
    return x, t, y, pos2, mask2


def guided_forward(model, inputs, plain=False, cfg_scale=CFG_SCALE):
    """One guided forward, through the kernels or (plain) their plain versions."""
    model.plain_kernels = plain
    try:
        with torch.inference_mode():
            out = model.forward_with_cfg(*inputs, cfg_scale)
    finally:
        model.plain_kernels = False
    if not torch.isfinite(out).all():
        raise AssertionError("non-finite guided forward")
    return out


def rel_rms(got, want) -> float:
    return ((got - want).pow(2).mean() / want.pow(2).mean()).sqrt().item()


def guided_forward_rel_rms(model, sampler_mod, head_dim, sizes, gen):
    """Relative RMS between one guided forward through the kernels and the
    same forward through their plain versions, at the given image sizes."""
    inputs = guided_inputs(sampler_mod, head_dim, sizes, gen)
    return rel_rms(guided_forward(model, inputs), guided_forward(model, inputs, plain=True))


def block_rel_rms(model, ra, inputs, gen):
    """One middle block of ``model`` on a random hidden state at the guided
    batch's shapes. Returns the relative RMS between the block's update
    through the kernels and through their plain versions, and that of the
    plain update under a BLOCK_PERTURBATION of the hidden state."""
    _, _, _, pos, mask = inputs
    n, hidden = pos.shape[0], model.hidden_size
    x = torch.randn((n, 256, hidden), generator=gen, device="cuda").to(model.dtype)
    c = torch.randn((n, hidden), generator=gen, device="cuda").to(model.dtype)
    cos, sin = ra.split_rope_tables(pos)
    lengths = mask.sum(-1, dtype=torch.int32)
    block = model.blocks[len(model.blocks) // 2]
    nudged = x * (1 + BLOCK_PERTURBATION)
    with torch.inference_mode():
        got = block(x, c, cos, sin, lengths, False) - x
        want = block(x, c, cos, sin, lengths, True) - x
        moved = block(nudged, c, cos, sin, lengths, True) - nudged
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite int8 block")
    return rel_rms(got.float(), want.float()), rel_rms(moved.float(), want.float())


def device_ms(fn, iters: int = 20) -> float:
    """Device time of ``fn()`` in ms, without the host's launch overhead:
    the launches of ``iters`` calls queue up behind a spin kernel, so the
    CUDA events around them time the card alone."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~60 ms at the H100's clocks: the host enqueues meanwhile
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def row_kernel_cases():
    """Phase 3b: each row kernel against its plain version, bf16, at the
    XL serving and sampling shapes, with its device time, its share of its
    bound and, for K3, its predecessor's time. Returns {name: (max_abs_err, kernel
    ms, plain ms, bound ms, bound by)} with the device times and the bound
    at batch 8 + CFG (4,096 rows)."""
    from fit_tpu_torch.cli.row_kernels_ab import ROW_SHAPES, VARIANTS, check, row_bytes, row_inputs

    results = {}
    for name, (width, _, fn, _) in VARIANTS.items():
        errs = []
        for b, t in ROW_SHAPES:
            args = row_inputs(name, b, t)
            got, want = fn(*args), fn(*args, plain=True)
            torch.cuda.synchronize()
            ok, err, detail = check(name, got, want)
            ms, plain_ms = device_ms(lambda: fn(*args)), device_ms(lambda: fn(*args, plain=True))
            wall_ms, plain_wall_ms = time_ms(lambda: fn(*args)), time_ms(lambda: fn(*args, plain=True))
            bound, bound_by = bound_ms(row_bytes(name, b, t), 0, torch.bfloat16)
            earlier = K3_EARLIER_US.get((b, t)) if name == "adaln_quant" else None
            print(
                f"row kernel vs plain: {name} rows={b * t} width={width} bf16 {detail} "
                f"max_abs_err={err:.3e} kernel_us={ms * 1e3:.1f} plain_us={plain_ms * 1e3:.1f} (device); "
                f"bound_us={bound * 1e3:.2f} by {bound_by}, {bound / ms:.0%} of it"
                + (f"; before it {earlier} ({earlier / (ms * 1e3):.2f}x faster)" if earlier else "")
                + f"; back to back, host-paced: kernel {wall_ms * 1e3:.1f} plain {plain_wall_ms * 1e3:.1f}",
                flush=True,
            )
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain version at {(b, t, width)}: {detail}")
            errs.append(err)
            if (b, t) == ROW_SHAPES[0]:
                results[name] = (ms, plain_ms, bound, bound_by)
        results[name] = (max(errs), *results[name])
    return results


def int8_forward_profile(qmodel, inputs, quant, smi) -> None:
    """Phase 5: one guided int8 FiT-XL/2 forward (16 rows x T 256) under
    torch.profiler: device time by group, and K3's total over its launches
    (two per block), each checked against the wrapper's count."""
    from fit_tpu_torch.cli.profile_train import group_of

    guided_forward(qmodel, inputs)
    torch.cuda.synchronize()
    quant.reset_launches()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        guided_forward(qmodel, inputs)
        torch.cuda.synchronize()
    launches = dict(quant.launches)
    by_group, k3_us, n_dev = {}, [], 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = evt.time_range.elapsed_us()
            group = group_of(evt.name)
            by_group[group] = by_group.get(group, 0.0) + us / 1e3
            n_dev += 1
            if "adaln_warp_rows" in evt.name or "adaln_block_rows" in evt.name:
                k3_us.append(us)
    dev_ms = sum(by_group.values())
    print(
        f"int8 forward profiled: FiT-XL/2 guided, 16 rows x T 256, bf16 + int8: device {dev_ms:.2f} ms in "
        f"{n_dev} activities; K3 (adaln_quant) {sum(k3_us) / 1e3:.4f} ms "
        f"over {len(k3_us)} launches, {sum(k3_us) / max(1, len(k3_us)):.2f} us each; "
        + ", ".join(f"{g} {v:.3f} ms" for g, v in sorted(by_group.items(), key=lambda kv: -kv[1]))
        + f"; {smi}",
        flush=True,
    )
    want = {"adaln_quant": 2 * DEPTH, "silu_mul_quant": DEPTH}
    if launches != want or len(k3_us) != 2 * DEPTH:
        raise AssertionError(f"profiled int8 forward: launches {launches}, K3 activities {len(k3_us)}; expected {want}")


def int8_gemm_line(quant) -> None:
    """The int8 product (torch._int_mm) at the XL qkv shape of batch 8 with
    CFG, with the weight stored (N, K) and passed transposed (the port's
    layout) and stored (K, N), beside the bf16 Linear on the same shape."""
    m, k, n = 4096, XL_HIDDEN, 3 * XL_HIDDEN
    gen = torch.Generator(device="cuda").manual_seed(1)
    xq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    w_nk = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
    w_kn = w_nk.t().contiguous()
    xb = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    wb = torch.randn((n, k), generator=gen, device="cuda").to(torch.bfloat16)
    if not torch.equal(quant._int_mm(xq, w_nk.t()), torch._int_mm(xq, w_kn)):
        raise AssertionError("torch._int_mm disagrees between weight layouts")
    t_nk = device_ms(lambda: quant._int_mm(xq, w_nk.t()), iters=50)
    t_kn = device_ms(lambda: torch._int_mm(xq, w_kn), iters=50)
    t_bf = device_ms(lambda: torch.nn.functional.linear(xb, wb), iters=50)
    ops = 2 * m * k * n
    print(
        f"int8 GEMM {m}x{k}x{n}: weight (N,K).t() {t_nk * 1e3:.1f} us ({ops / t_nk / 1e9:.0f} TOPS), "
        f"(K,N) {t_kn * 1e3:.1f} us; bf16 F.linear {t_bf * 1e3:.1f} us ({ops / t_bf / 1e9:.0f} TFLOP/s)",
        flush=True,
    )


def post_sample(base: str, body: dict):
    """POST /sample; returns (status, latent, (H, W, 3) uint8 image of an
    image/png body, or error text)."""
    req = urllib.request.Request(f"{base}/sample", data=json.dumps(body).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            data = resp.read()
            if resp.headers["Content-Type"] == "image/png":
                from PIL import Image

                return resp.status, np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
            return resp.status, np.load(io.BytesIO(data))
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


FIRST_REQUEST = {"label": 3, "height": 256, "width": 256, "seed": 42}


def request_burst(base: str):
    """12 seeded requests of mixed sizes to the server at ``base``: one
    alone in its batch, then eleven at once, among them the first one's
    seed again. Returns the (body, (status, latent)) pairs, the wall
    seconds, /stats and /healthz."""
    t0 = time.perf_counter()
    responses = [(FIRST_REQUEST, post_sample(base, FIRST_REQUEST))]  # alone in its batch
    burst = [
        {"label": 100 + 37 * i, "height": h, "width": w, "seed": 1000 + i}
        for i, (h, w) in enumerate((MIXED_SIZES * 3)[:10])
    ]
    burst.insert(5, dict(FIRST_REQUEST))  # the same seed, now among ten others
    with ThreadPoolExecutor(len(burst)) as pool:
        responses += list(zip(burst, pool.map(lambda b: post_sample(base, b), burst)))
    wall = time.perf_counter() - t0
    with urllib.request.urlopen(f"{base}/stats", timeout=60) as resp:
        stats = json.loads(resp.read())
    with urllib.request.urlopen(f"{base}/healthz", timeout=60) as resp:
        health = json.loads(resp.read())
    return responses, wall, stats, health


def check_burst(responses, stats, health, pixels: bool = False) -> float:
    """Every response a 200 with a finite latent of its size (``pixels``: a
    PNG of its height and width), every request served; returns the
    repeated seed's max |difference|."""
    for body, (status, out) in responses:
        if status != 200:
            raise AssertionError(f"/sample {body} -> {status}: {out}")
        if pixels:
            want, dtype = (body["height"], body["width"], 3), np.uint8
        else:
            want, dtype = (4, body["height"] // 8, body["width"] // 8), np.float32
        if tuple(out.shape) != want or out.dtype != dtype or not np.isfinite(out).all():
            raise AssertionError(f"/sample {body}: bad body {out.shape} {out.dtype}, expected {want} {dtype}")
    repeat = [out.astype(np.float64) for body, (_, out) in responses if body == FIRST_REQUEST]
    if health != {"status": "ok"} or stats["served"] != len(responses):
        raise AssertionError(f"/stats served {stats['served']} of {len(responses)}; /healthz {health}")
    return float(np.abs(repeat[0] - repeat[1]).max())


def serve_phase(qmodel, serve_mod, make_handler, kernel_modules):
    """Phase 5, serving: SamplingServer + the HTTP handler on a free local
    port; 12 seeded requests of mixed sizes, one seed twice in two batch
    compositions. Returns the launch counts of this path and its numbers."""
    server = serve_mod.SamplingServer(
        qmodel, batch_size=SERVE_BATCH, max_batch_wait_s=0.1, num_sampling_steps=SERVE_STEPS,
        cfg_scale=CFG_SCALE, sampler="ddim", device="cuda",
    )
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    try:
        warm_s = server.warmup(timeout=600)
        for mod in kernel_modules:
            mod.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        responses, wall, stats, health = request_burst(base)
        launches = kernel_launches(*kernel_modules)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
        http_thread.join(timeout=60)
    peak = torch.cuda.max_memory_allocated()
    seed_diff = check_burst(responses, stats, health)
    batches = stats["batches"]
    per_step = {k: 0 for k in launches}
    per_step.update(rope_attention_fwd=DEPTH, adaln_quant=2 * DEPTH, silu_mul_quant=DEPTH)
    expected = {k: v * SERVE_STEPS * batches for k, v in per_step.items()}
    if launches != expected:
        raise AssertionError(f"serving launches {launches}, expected {expected} for {batches} batches")
    print(
        f"serve: FiT-XL/2 int8 256x256 DDIM {SERVE_STEPS} steps cfg {CFG_SCALE} batch {SERVE_BATCH} over HTTP: "
        f"{len(responses)} requests in {batches} batches, {wall:.3f} s wall, "
        f"{wall / (batches * SERVE_STEPS) * 1e3:.2f} ms/step, {len(responses) / wall:.3f} img/s; "
        f"latency p50 {stats['latency_p50_s'] * 1e3:.1f} ms p95 {stats['latency_p95_s'] * 1e3:.1f} ms; "
        f"occupancy {stats['occupancy']:.3f}; warmup {warm_s:.2f} s; "
        f"repeated seed max|diff|={seed_diff:.3e} (bit-identical: {seed_diff == 0.0}); "
        f"launches {launches}; max_memory_allocated {peak / 2**30:.2f} GiB",
        flush=True,
    )
    if not seed_diff <= SEED_REPEAT_ATOL:
        raise AssertionError(f"a repeated seed drifted by {seed_diff} across batch compositions")
    return launches

# 7. DiT-XL/2 at 512^2 (Peebles & Xie 2023, Table 4): 64 x 64 latents, patch
# 2, T = 1024, batch 8 with CFG = 16 rows, every block through K1 with RoPE
# off; and K1's strided (B, T, H, d) entry with RoPE on
DIT_STEPS = 10
DIT_CFG = 4.0
DIT_DEPTH = 28
DIT_SIDE = 64  # latent side at 512^2
PADDED_1024 = [1024, 700, 513, 1] * 4
PADDED16 = [256, 256, 200, 130, 64, 1, 255, 129, 256, 256, 224, 180, 256, 33, 2, 256]
# (name, H, d, T, lengths): RoPE off through masked_attention on (B, H, T, d)
# views of a packed projection; RoPE on through rope_flash_attention on
# contiguous (B, T, H, d) tensors and on views of a (B, T, 3, H, d) projection
STRIDED_CASES = [
    ("masked_attention", "views", 16, 72, 1024, [1024] * 16),  # the DiT-XL/2 512^2 call
    ("masked_attention", "views", 16, 72, 1024, PADDED_1024),
    ("masked_attention", "views", 16, 64, 256, PADDED16),
    ("rope_flash_attention", "contiguous", 16, 72, 256, [256] * 16),  # row 2's shape
    ("rope_flash_attention", "views", 16, 72, 256, [256] * 16),
    ("rope_flash_attention", "contiguous", 16, 72, 256, PADDED16),
    ("rope_flash_attention", "views", 16, 72, 256, PADDED16),
]


def strided_case(ra, attn, rope_freqs_2d, name, layout, h, d, t, lengths, dtype, seed):
    """Phase 7a on one case: the entry through K1 against its plain version
    on the same inputs (max abs error over valid query rows), with the
    device times of the kernel, the plain version and SDPA (on the same
    views with the boolean key mask; on pre-rotated q, k for the RoPE entry,
    so it excludes RoPE), and the bound: each operand read once, the output
    written once, 2 products of 2 * T * len * d per (row, head) over the
    valid keys. Returns a dict of these."""
    b = len(lengths)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, t, 3 * h * d), generator=gen, device="cuda").to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    mask = (torch.arange(t, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    scale = d**-0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    es = torch.finfo(dtype).bits // 8
    nbytes = 4 * b * t * h * d * es + 4 * b
    if name == "masked_attention":
        q, k, v = qkv.view(b, t, 3, h, d).transpose(1, 3).unbind(2)  # (B, H, T, d) views

        def kernel():
            return attn.masked_attention(q, k, v, lengths=lens)

        def plain(cast=False):
            xs = (q.float(), k.float(), v.float()) if cast else (q, k, v)
            return attn.masked_attention_reference(*xs, lens, scale)

        def library():
            return sdpa(q, k, v, attn_mask=mask, scale=scale)

        rows = 2  # (B, H, T, d): query rows on dim 2
    else:
        side = int(t**0.5)
        fc = torch.from_numpy(rope_freqs_2d(d, side, side)).float().cuda()
        cos, sin = (x.expand(b, t, d).contiguous() for x in ra.split_rope_tables(fc))
        q, k, v = qkv.view(b, t, 3, h, d).unbind(2)
        if layout == "contiguous":
            q, k, v = (x.contiguous() for x in (q, k, v))
        qr, kr = (ra._rope_heads(x, cos, sin).to(dtype).transpose(1, 2).contiguous() for x in (q, k))
        vh = v.transpose(1, 2).contiguous()
        nbytes += 2 * b * t * d * 4

        def kernel():
            return ra.rope_flash_attention(q, k, v, cos, sin, lens, scale)

        def plain(cast=False):
            xs = (q.float(), k.float(), v.float()) if cast else (q, k, v)
            return ra.rope_flash_reference(*xs, cos, sin, lens, scale)

        def library():
            return sdpa(qr, kr, vh, attn_mask=mask, scale=scale)

        rows = 1  # (B, T, H, d): query rows on dim 1
    got = kernel()
    torch.cuda.synchronize()
    want = plain(cast=True)
    if not torch.isfinite(got).all():
        raise AssertionError(f"non-finite {name} output at {(b, t, h, d, dtype)}")
    err = max(
        (got[i].narrow(rows - 1, 0, n).float() - want[i].narrow(rows - 1, 0, n)).abs().max().item()
        for i, n in enumerate(lengths)
    )
    tol = BF16_ATOL if dtype == torch.bfloat16 else FP32_ATOL
    res = {
        "max_abs_err": err,
        "ms": device_ms(kernel),
        "plain_ms": device_ms(plain, iters=5),
        "library_ms": device_ms(library),
    }
    flops = 2 * sum(2 * t * n * d * h for n in lengths)
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops, dtype)
    res["fma_bound_ms"], fma_by = bound_ms(nbytes, flops, dtype, FP32_FMA_FLOPS)
    print(
        f"K1 {name} ({layout}, RoPE {'off' if name == 'masked_attention' else 'on'}) vs plain: B={b} T={t} H={h} "
        f"d={d} {str(dtype).removeprefix('torch.')} lengths min {min(lengths)} max_abs_err={err:.3e} (tol {tol:g}); "
        f"device us: kernel {res['ms'] * 1e3:.1f} plain {res['plain_ms'] * 1e3:.1f} SDPA {res['library_ms'] * 1e3:.1f}"
        f"{' (excludes RoPE)' if name != 'masked_attention' else ''} bound {res['bound_ms'] * 1e3:.1f} "
        f"by {res['bound_by']}"
        + (f" (at the fp32 FMA rate {res['fma_bound_ms'] * 1e3:.1f} by {fma_by})" if dtype == torch.float32 else ""),
        flush=True,
    )
    if not err <= tol:
        raise AssertionError(f"{name} disagrees with its plain version: {err} > {tol}")
    return res


def dit_phase(kernel_modules):
    """Phase 7b: DiT-XL/2 bf16 with seeded random weights samples 512x512
    (64 x 64 latents) with DDPM, LEARNED_RANGE and CFG at batch 8. Checks
    one guided forward through the kernels against the plain kernels, the
    output and every launch count; profiles one denoise step. Returns this
    path's launch counts."""
    from fit_tpu_torch.cli.profile_train import group_of
    from fit_tpu_torch.diffusion.gaussian import create_diffusion
    from fit_tpu_torch.diffusion.samplers import p_sample_loop
    from fit_tpu_torch.models.dit import create_dit
    from fit_tpu_torch.sampling import cast_for_sampling

    gen = torch.Generator(device="cuda").manual_seed(7)
    model = create_dit("DiT-XL/2", dtype=torch.bfloat16, device="cuda")
    with torch.no_grad():
        for p in model.parameters():  # the reference init zeroes adaLN and the final layer
            p.normal_(0.0, 0.02, generator=gen)
    cast_for_sampling(model, torch.device("cuda"))
    diffusion = create_diffusion(str(DIT_STEPS), learn_sigma=True)
    labels = torch.arange(0, 1000, 1000 // BATCH, device="cuda")[:BATCH]
    y = torch.cat([labels, torch.full_like(labels, model.num_classes)])

    def model_fn(x, t):
        return model.forward_with_cfg(x, t, y, DIT_CFG)

    x = torch.randn((2 * BATCH, 4, DIT_SIDE, DIT_SIDE), generator=gen, device="cuda")
    t = torch.full((2 * BATCH,), 500, device="cuda")
    inputs = (torch.cat([x[:BATCH], x[:BATCH]]), t, y)
    rel = rel_rms(guided_forward(model, inputs, cfg_scale=DIT_CFG), guided_forward(model, inputs, plain=True, cfg_scale=DIT_CFG))
    print(f"DiT-XL/2 512^2 guided forward, kernels vs plain kernels: rel_rms {rel:.3e} (tol {FORWARD_REL_RMS:g})", flush=True)
    if not rel <= FORWARD_REL_RMS:
        raise AssertionError("the guided DiT forward through the kernel disagrees with the plain one")

    z = torch.randn((BATCH, 4, DIT_SIDE, DIT_SIDE), generator=gen, device="cuda")
    for mod in kernel_modules:
        mod.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.inference_mode():
        latents = p_sample_loop(diffusion, model_fn, torch.cat([z, z]), gen, clip_denoised=False)[:BATCH]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = kernel_launches(*kernel_modules)
    want = {k: 0 for k in launches}
    want["masked_attention"] = DIT_DEPTH * DIT_STEPS
    want.update(float_glue(DIT_STEPS, DIT_DEPTH, swiglu=False))  # one guided forward a step
    if launches != want:
        raise AssertionError(f"DiT sampling launches {launches}, expected {want}")
    if tuple(latents.shape) != (BATCH, 4, DIT_SIDE, DIT_SIDE) or not torch.isfinite(latents).all():
        raise AssertionError(f"bad DiT sample output: {tuple(latents.shape)}")

    # one denoise step (guided forward + DDPM update): host enqueue against
    # the device time by group, then under torch.profiler
    wrapped = diffusion.wrap_model(model_fn)
    xt = torch.cat([z, z])
    ts = torch.full((2 * BATCH,), DIT_STEPS - 1, dtype=torch.long, device="cuda")
    noise = torch.randn(xt.shape, generator=gen, device="cuda")

    def step():
        with torch.inference_mode():
            return diffusion.p_sample(wrapped, xt, ts, noise, False)["sample"]

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    step_alone_ms = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step()
        torch.cuda.synchronize()
    by_group, n_dev = {}, 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            group = group_of(evt.name)
            by_group[group] = by_group.get(group, 0.0) + evt.time_range.elapsed_us() / 1e3
            n_dev += 1
    device_ms_step = sum(by_group.values())
    print(
        f"DiT-XL/2 512x512 DDPM {DIT_STEPS} steps cfg {DIT_CFG} batch {BATCH} (16 rows x T 1024), bf16: "
        f"{wall / DIT_STEPS * 1e3:.2f} ms/step, {BATCH / wall:.3f} img/s; max_memory_allocated {peak / 2**30:.2f} GiB; "
        f"launches {launches}",
        flush=True,
    )
    print(
        f"DiT step alone: host clock {step_alone_ms:.2f} ms, host enqueue {enqueue_ms:.2f} ms; device (profiler) "
        f"{device_ms_step:.2f} ms in {n_dev} activities, idle share {max(0.0, 1 - device_ms_step / step_alone_ms):.3f}; "
        + ", ".join(f"{g} {v:.2f} ms" for g, v in sorted(by_group.items(), key=lambda kv: -kv[1])),
        flush=True,
    )
    return launches, latents


# 7d. DiT-MoE-G/2-16E2A (arXiv:2407.11633) at its published widths: D 1408,
# 16 heads of 88, 16 routed SwiGLU experts of 5632, top-2 not renormalised,
# a shared expert of 2816. The benchmark cell samples batch 32 with CFG: 64
# rows x T 256 = 16,384 tokens a forward, 32,768 routed rows
MOE_DIM, MOE_HEADS, MOE_EXPERTS, MOE_TOP_K, MOE_HIDDEN, MOE_SHARED = 1408, 16, 16, 2, 5632, 2816
MOE_BATCH = 32
MOE_TOKENS = 2 * MOE_BATCH * 256
MOE_DEPTH = 2  # of 40: every width and every kernel of a block, in 2 x 0.8 GB of bf16
MOE_STEPS = 5


def moe_kernel_cases():
    """Phase 7d: K7 (``moe_combine``: k = 2 expert rows and the shared row
    a token) and K6 on the ``[gate | up]`` halves (``swiglu_halves``, every
    routed row) against their plain versions, bf16, at the DiT-MoE cell's
    shapes: at most one bf16 ulp apart, with the device time of both, the
    bound and the kernel's share of it. Returns {name: (max_abs_err, kernel
    ms, plain ms, bound ms, bound by)}."""
    from fit_tpu_torch.cli.row_kernels_ab import bf16_ulps
    from fit_tpu_torch.ops import fused_adaln

    gen = torch.Generator(device="cuda").manual_seed(17)
    n, k, d, h = MOE_TOKENS, MOE_TOP_K, MOE_DIM, MOE_HIDDEN
    ys = torch.randn((n * k, d), generator=gen, device="cuda").to(torch.bfloat16)
    pos = torch.randperm(n * k, generator=gen, device="cuda").view(n, k)
    w = torch.rand((n, k), generator=gen, device="cuda") * 0.5  # top-2 of 16 softmax scores
    shared = torch.randn((n, d), generator=gen, device="cuda").to(torch.bfloat16)
    gate_up = torch.randn((n * k, 2 * h), generator=gen, device="cuda").to(torch.bfloat16)
    cases = {  # name: (shape, call, bytes read and written)
        "moe_combine": (f"{n} x {d}, k {k}, with shared",
                        lambda plain=False: fused_adaln.moe_combine(ys, pos, w, shared, plain=plain),
                        (n * k + 2 * n) * d * 2 + n * k * (8 + 4)),
        "swiglu_halves": (f"{n * k} x {h} ([gate | up] rows of {2 * h})",
                          lambda plain=False: fused_adaln.swiglu_halves(gate_up, plain=plain),
                          n * k * 3 * h * 2),
    }
    results = {}
    for name, (shape, fn, nbytes) in cases.items():
        got, want = fn(), fn(plain=True)
        torch.cuda.synchronize()
        ulps, err = bf16_ulps(got, want), (got.float() - want.float()).abs().max().item()
        ms, plain_ms = device_ms(fn), device_ms(lambda: fn(plain=True))
        bound, bound_by = bound_ms(nbytes, 0, torch.bfloat16)
        print(
            f"MoE kernel vs plain: {name} {shape} bf16 max_ulps={ulps:.3f} max_abs_err={err:.3e} "
            f"kernel_us={ms * 1e3:.1f} plain_us={plain_ms * 1e3:.1f} (device); "
            f"bound_us={bound * 1e3:.2f} by {bound_by}, {bound / ms:.0%} of it",
            flush=True,
        )
        if not ulps <= 1:
            raise AssertionError(f"{name} disagrees with its plain version at {shape}: {ulps:.3f} ulps")
        results[name] = (err, ms, plain_ms, bound, bound_by)
    del ys, pos, w, shared, gate_up
    return results


def ditmoe_phase(kernel_modules, smi):
    """Phase 7d: the sparse-MoE kernels at the cell's shapes
    (:func:`moe_kernel_cases`), then DiT-MoE-G/2-16E2A's first MOE_DEPTH
    blocks, bf16 with seeded random weights (router in fp32), through DiT's
    sampling path at 256^2: one guided forward against the plain kernels,
    then DDIM with CFG at the cell's batch, checking the output and every
    launch count. Returns (the kernel cases, this path's launch counts)."""
    from fit_tpu_torch.diffusion.gaussian import create_diffusion
    from fit_tpu_torch.diffusion.samplers import ddim_sample_loop
    from fit_tpu_torch.models.dit import DiT
    from fit_tpu_torch.ops import LAUNCHES
    from fit_tpu_torch.sampling import cast_for_sampling

    print(f"phase 7d on: {smi}", flush=True)
    cases = moe_kernel_cases()
    gen = torch.Generator(device="cuda").manual_seed(11)
    model = DiT(depth=MOE_DEPTH, hidden_size=MOE_DIM, num_heads=MOE_HEADS, num_experts=MOE_EXPERTS,
                num_experts_per_tok=MOE_TOP_K, shared_hidden=MOE_SHARED, dtype=torch.bfloat16, device="cuda")
    with torch.no_grad():
        for p in model.parameters():  # the reference init zeroes adaLN and the final layer
            p.normal_(0.0, 0.02, generator=gen)
    cast_for_sampling(model, torch.device("cuda"))
    diffusion = create_diffusion(str(MOE_STEPS), learn_sigma=True)
    labels = torch.arange(0, 1000, 1000 // MOE_BATCH, device="cuda")[:MOE_BATCH]
    y = torch.cat([labels, torch.full_like(labels, model.num_classes)])
    z = torch.randn((MOE_BATCH, 4, 32, 32), generator=gen, device="cuda")
    t = torch.full((2 * MOE_BATCH,), 500, device="cuda")
    inputs = (torch.cat([z, z]), t, y)
    rel = rel_rms(guided_forward(model, inputs), guided_forward(model, inputs, plain=True))
    print(f"DiT-MoE-G/2 ({MOE_DEPTH} blocks) guided forward, kernels vs plain kernels: rel_rms {rel:.3e} "
          f"(tol {FORWARD_REL_RMS:g})", flush=True)
    if not rel <= FORWARD_REL_RMS:
        raise AssertionError("the guided DiT-MoE forward through the kernels disagrees with the plain one")

    def model_fn(x, ts):
        return model.forward_with_cfg(x, ts, y, CFG_SCALE)

    for mod in kernel_modules:
        mod.reset_launches()
    LAUNCHES["moe_grouped_mm"] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.inference_mode():
        latents = ddim_sample_loop(diffusion, model_fn, torch.cat([z, z]), clip_denoised=False)[:MOE_BATCH]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches(*kernel_modules)
    want = {k: 0 for k in launches}
    want.update(float_glue(MOE_STEPS, MOE_DEPTH), masked_attention=MOE_DEPTH * MOE_STEPS,
                swiglu_glue=2 * MOE_DEPTH * MOE_STEPS,  # the routed rows and the shared expert's
                moe_combine=MOE_DEPTH * MOE_STEPS)
    if launches != want or LAUNCHES["moe_grouped_mm"] != 2 * MOE_DEPTH * MOE_STEPS:
        raise AssertionError(f"DiT-MoE sampling launches {launches} and {LAUNCHES['moe_grouped_mm']} grouped "
                             f"GEMMs, expected {want} and {2 * MOE_DEPTH * MOE_STEPS}")
    if tuple(latents.shape) != (MOE_BATCH, 4, 32, 32) or not torch.isfinite(latents).all():
        raise AssertionError(f"bad DiT-MoE sample output: {tuple(latents.shape)}")
    print(
        f"DiT-MoE-G/2 ({MOE_DEPTH} of 40 blocks) 256x256 DDIM {MOE_STEPS} steps cfg {CFG_SCALE} batch {MOE_BATCH} "
        f"({2 * MOE_BATCH} rows x T 256), bf16: {wall / MOE_STEPS * 1e3:.2f} ms/step (first call, host-paced); "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}",
        flush=True,
    )
    del model
    return cases, launches


def fit_absolute_check(sampler_mod) -> None:
    """Phase 7c: one guided FiT-XL/2 forward with pos_kind="absolute" and
    ffn="mlp" over MIXED_SIZES (prefix masks, T 256), kernels vs plain."""
    from fit_tpu_torch.models.fit import create_fit

    gen = torch.Generator(device="cuda").manual_seed(8)
    model = create_fit("FiT-XL/2", dtype=torch.bfloat16, pos_kind="absolute", ffn="mlp", device="cuda")
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=gen)
    sampler_mod.cast_for_sampling(model, torch.device("cuda"))
    inputs = guided_inputs(sampler_mod, model.hidden_size, MIXED_SIZES, gen, method="absolute")
    rel = rel_rms(guided_forward(model, inputs), guided_forward(model, inputs, plain=True))
    print(
        f"FiT-XL/2 pos_kind=absolute ffn=mlp guided forward over {MIXED_SIZES}, kernels vs plain kernels: "
        f"rel_rms {rel:.3e} (tol {FORWARD_REL_RMS:g})",
        flush=True,
    )
    if not rel <= FORWARD_REL_RMS:
        raise AssertionError("the FiT absolute forward through the kernel disagrees with the plain one")


# 8. the command line, at FiT-XL/2 width and full depth on phase 4's seeded
# weights: a reference (PyTorch Lightning) checkpoint written under build/,
# sampled, quantized and served through the CLIs
CLI_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_cli"
CLI_EMA_SCALE = 0.5  # the checkpoint's EMA copy: the weights times this, so a load of the wrong copy shows
SERVE_READY_S = 600  # the longest the serve CLI may take to print its listening line
SERVE_EXIT_S = 120  # and to exit after SIGINT
_REFERENCE_NAMES = (
    ("t_embedder.fc1.", "t_embedder.mlp.0."), ("t_embedder.fc2.", "t_embedder.mlp.2."),
    ("y_embedder.table.", "y_embedder.embedding_table."),
    ("final.adaLN.", "final_layer.adaLN_modulation.1."), ("final.linear.", "final_layer.linear."),
)


def reference_key(name: str) -> str:
    """A port state-dict key -> the reference module's (Lightning adds ``model.``)."""
    for port, ref in _REFERENCE_NAMES:
        if name.startswith(port):
            return "model." + ref + name[len(port):]
    return "model." + name.replace(".adaLN.", ".adaLN_modulation.1.")


def cli_launches(kernel_modules, run):
    """``run()`` with every launch count set to 0 just before; returns its
    result and the counts just after."""
    for mod in kernel_modules:
        mod.reset_launches()
    out = run()
    torch.cuda.synchronize()
    return out, kernel_launches(*kernel_modules)


def expect_launches(what, launches, **per_run):
    want = {k: 0 for k in launches}
    want.update(per_run)
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def serve_cli_phase(artifact: Path, vae_dir: "Path | None" = None):
    """8d: ``python -m fit_tpu_torch.cli.serve`` from the int8 artifact, in a
    subprocess on 127.0.0.1 (a free port), DPM-Solver++ 10 steps at batch
    8 (with ``vae_dir``: ``--vae-checkpoint``, PNG bodies): the 12 requests
    of phase 5, then SIGINT, after which it must exit 0 and print its
    kernels' launch counts, which must be those of its batches (the warm-up
    batch included). Returns the burst's numbers and the launch counts."""
    cmd = [sys.executable, "-m", "fit_tpu_torch.cli.serve", "--checkpoint-path", str(artifact), "--sampler", "dpm",
           "--num-sampling-steps", str(SERVE_STEPS), "--serve-batch-size", str(SERVE_BATCH),
           "--max-batch-wait-s", "0.1", "--host", "127.0.0.1", "--port", "0", "--device", "cuda"]
    if vae_dir is not None:
        cmd += ["--vae-checkpoint", str(vae_dir)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env={**os.environ, "PYTHONUNBUFFERED": "1"})
    lines: "queue.Queue[str]" = queue.Queue()
    log = []
    reader = threading.Thread(target=lambda: [lines.put(line) for line in proc.stdout], daemon=True)
    reader.start()
    try:
        base = None
        while base is None:
            remaining = SERVE_READY_S - (time.perf_counter() - t0)
            if remaining <= 0 or proc.poll() is not None:
                raise AssertionError(f"the serve CLI did not start listening: {''.join(log[-20:])}")
            try:
                line = lines.get(timeout=min(remaining, 5))
            except queue.Empty:
                continue
            log.append(line)
            found = re.search(r"listening on (http://127\.0\.0\.1:\d+)", line)
            base = found.group(1) if found else None
        ready_s = time.perf_counter() - t0
        responses, wall, stats, health = request_burst(base)
        proc.send_signal(signal.SIGINT)
        code = proc.wait(timeout=SERVE_EXIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        reader.join(timeout=60)
    while not lines.empty():
        log.append(lines.get())
    if code != 0:
        raise AssertionError(f"the serve CLI exited {code} after SIGINT: {''.join(log[-20:])}")
    seed_diff = check_burst(responses, stats, health, pixels=vae_dir is not None)
    if seed_diff != 0.0:
        raise AssertionError(f"a repeated seed under dpm drifted by {seed_diff} across batch compositions")
    found = [line for line in log if line.startswith("[serve] kernel launches: ")]
    if not found:
        raise AssertionError(f"the serve CLI printed no launch counts: {''.join(log[-20:])}")
    launches = json.loads(found[-1].split(": ", 1)[1])
    forwards = SERVE_STEPS * (stats["batches"] + 1)  # one guided forward a step; the warm-up batch too
    expect_launches("cli.serve" + (" --vae-checkpoint" if vae_dir else ""), launches, rope_attention_fwd=DEPTH * forwards,
                    adaln_quant=2 * DEPTH * forwards, silu_mul_quant=DEPTH * forwards)
    return {"ready_s": ready_s, "wall": wall, "stats": stats, "n": len(responses), "launches": launches}


def cli_phase(kernel_modules, smi, ddim_step_ms):
    """Phase 8, the command line, writing under CLI_DIR (its checkpoint and
    VAE serve phase 10 too; main deletes the directory after phase 10).
    Returns its launch counts (all CLI runs in this process)."""
    from fit_tpu_torch import sampling as sampler_mod
    from fit_tpu_torch.cli.k1_fp32_ab import fp32_forward_profile
    from fit_tpu_torch.cli import quantize as cli_quantize
    from fit_tpu_torch.cli import sample as cli_sample
    from fit_tpu_torch.models.fit import create_fit
    from fit_tpu_torch.ops.equalize import calibrate, equalize_params, synthetic_calib_batch
    from fit_tpu_torch.utils.config import SampleConfig

    cuda = torch.device("cuda")
    print(f"phase 8 on: {smi}", flush=True)
    # 8a. the reference checkpoint: phase 4's weights, an EMA copy beside them
    model = seeded_fit_xl(create_fit, torch.Generator(device="cuda").manual_seed(0))
    weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model
    ema = {k: v * CLI_EMA_SCALE for k, v in weights.items()}
    ckpt = CLI_DIR / "last.ckpt"
    t0 = time.perf_counter()
    torch.save({"state_dict": {reference_key(k): v for k, v in weights.items()},
                "optimizer_states": [{"ema": list(ema.values())}], "epoch": 0, "global_step": 0}, ckpt)
    write_s = time.perf_counter() - t0
    del weights
    cfg = SampleConfig(model="FiT-XL/2", num_sampling_steps=STEPS, cfg_scale=CFG_SCALE)
    t0 = time.perf_counter()
    loaded = cli_sample.load_model_and_params(cfg, torch_checkpoint=str(ckpt), device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    wrong = [k for k, v in loaded.state_dict().items() if not torch.equal(v.cpu(), ema[k])]
    if wrong:
        raise AssertionError(f"the CLI loaded other weights than the checkpoint's EMA copy: {wrong[:4]}")
    print(f"cli: reference checkpoint {ckpt.stat().st_size / 2**30:.3f} GiB (weights and EMA, fp32) written in "
          f"{write_s:.2f} s; load_model_and_params took its EMA in {load_s:.2f} s", flush=True)

    # 8b. sample through the CLI: dpm, then ddim, ddim packed over the mixed sizes, and fp32
    common = ["--model", "FiT-XL/2", "--num-sampling-steps", str(STEPS), "--cfg-scale", str(CFG_SCALE),
              "--num-samples", str(BATCH), "--batch-size", str(BATCH), "--image-height", "256",
              "--image-width", "256", "--device", "cuda", "--torch-checkpoint", str(ckpt)]
    totals = {}

    def run_cli(what, main, argv, **per_run):
        out, launches = cli_launches(kernel_modules, lambda: main(argv))
        expect_launches(what, launches, **per_run)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        return out

    k1_run = DEPTH * STEPS  # one guided forward a step, one K1 launch a block
    glue = float_glue(STEPS)
    dpm = run_cli("cli.sample dpm", cli_sample.main, common + ["--sampler", "dpm", "--output-dir", str(CLI_DIR / "dpm")],
                  rope_attention_fwd=k1_run, **glue)
    files = sorted((CLI_DIR / "dpm").glob("latent_*.npy"))
    saved = [np.load(f) for f in files]
    if len(files) != BATCH or any(a.shape != (4, 32, 32) or not np.isfinite(a).all() for a in saved):
        raise AssertionError(f"cli.sample wrote {len(files)} latents: {[a.shape for a in saved]}")
    labels, generator = cli_sample.batch_draws(cfg.global_seed, 0, BATCH, cfg.num_classes, cuda)
    ref_model = create_fit("FiT-XL/2", dtype=torch.bfloat16, device="cuda")
    ref_model.load_state_dict(ema)
    del ema
    ref_sampler = sampler_mod.FiTSampler(ref_model, num_sampling_steps=STEPS, cfg_scale=CFG_SCALE, sampler="dpm",
                                         device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = ref_sampler.sample(labels, 256, 256, generator=generator)
    torch.cuda.synchronize()
    dpm_step_ms = (time.perf_counter() - t0) / STEPS * 1e3
    got = np.stack(dpm["latents"])
    same = labels == dpm["labels"] and np.array_equal(got, want.cpu().numpy())
    print(f"cli.sample dpm: FiT-XL/2 256x256 {STEPS} steps cfg {CFG_SCALE} batch {BATCH} from the reference "
          f"checkpoint's EMA: {len(files)} latents, bit-identical to FiTSampler on the same weights, labels and "
          f"generator: {same}; {dpm_step_ms:.2f} ms/step in-process (CLI batch {dpm['seconds'][0] / STEPS * 1e3:.2f} "
          f"ms/step; phase 4's DDIM {ddim_step_ms:.2f} ms/step)", flush=True)
    if not same:
        raise AssertionError(f"the CLI's latents differ from FiTSampler's: max |diff| "
                             f"{float(np.abs(got - want.cpu().numpy()).max())}")
    del ref_sampler, want

    ddim = run_cli("cli.sample ddim", cli_sample.main,
                   common + ["--sampler", "ddim", "--output-dir", str(CLI_DIR / "ddim")], rope_attention_fwd=k1_run,
                   **glue)
    if not all(np.isfinite(x).all() for x in ddim["latents"]):
        raise AssertionError("cli.sample ddim: non-finite latents")
    sizes = ",".join(f"{h}x{w}" for h, w in MIXED_SIZES)
    mixed = run_cli("cli.sample ddim mixed", cli_sample.main,
                    common + ["--sampler", "ddim", "--image-sizes", sizes, "--output-dir", str(CLI_DIR / "mixed")],
                    rope_attention_fwd=k1_run, **glue)
    want_shapes = [(4, MIXED_SIZES[i % 4][0] // 8, MIXED_SIZES[i % 4][1] // 8) for i in range(BATCH)]
    if [lat.shape for lat in mixed["latents"]] != want_shapes or not all(np.isfinite(x).all() for x in mixed["latents"]):
        raise AssertionError(f"cli.sample mixed: {[lat.shape for lat in mixed['latents']]}")
    fp32 = run_cli("cli.sample fp32", cli_sample.main,
                   common + ["--sampler", "ddim", "--dtype", "float32", "--output-dir", str(CLI_DIR / "fp32")],
                   rope_attention_fwd=k1_run, **glue)
    if not all(np.isfinite(x).all() for x in fp32["latents"]):
        raise AssertionError("cli.sample --dtype float32: non-finite latents")
    print(f"cli.sample ddim batch {BATCH}: {ddim['seconds'][0] / STEPS * 1e3:.2f} ms/step; ddim packed over {sizes} "
          f"batch {BATCH}: {mixed['seconds'][0] / STEPS * 1e3:.2f} ms/step; "
          f"--dtype float32 ddim batch {BATCH}: {fp32['seconds'][0] / STEPS * 1e3:.2f} ms/step (CLI batch times, "
          f"host clock to the read-back)", flush=True)
    # beside the fp32 CLI step: one guided fp32 forward of the same shape on the card, by group
    prof = fp32_forward_profile()
    print(
        f"fp32 guided FiT-XL/2 forward profiled (16 rows x T 256, TF32 off, seeded weights): device "
        f"{prof['device_ms']:.2f} ms; " + ", ".join(
            f"{g} {v:.3f} ms" for g, v in sorted(prof["by_group_ms"].items(), key=lambda kv: -kv[1]))
        + f"; K1 launches {prof['k1_launches']}; {smi}",
        flush=True,
    )
    if prof["k1_launches"] != DEPTH or prof["by_group_ms"].get("K1 attention forward", 0.0) <= 0.0:
        raise AssertionError(f"the profiled fp32 forward launched K1 {prof['k1_launches']} times, expected {DEPTH}")

    # 8c. quantize through the CLI, without and with SmoothQuant on 2 batches
    art, art_eq = CLI_DIR / "int8", CLI_DIR / "int8_eq"
    t0 = time.perf_counter()
    run_cli("cli.quantize", cli_quantize.main, common + ["--output", str(art)])
    quant_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_cli("cli.quantize --equalize 2", cli_quantize.main, common + ["--output", str(art_eq), "--equalize", "2"],
            rope_attention_fwd=2 * DEPTH, **float_glue(2))  # one calibration forward a batch
    quant_eq_s = time.perf_counter() - t0
    art_bytes = dir_bytes(art_eq)
    qcfg = SampleConfig(**{**json.loads((art_eq / "config.json").read_text()), "checkpoint_path": str(art_eq)})
    qmodel = sampler_mod.cast_for_sampling(cli_sample.load_model_and_params(qcfg, device="cuda"), cuda)
    gen = torch.Generator(device="cuda").manual_seed(8)
    inputs = guided_inputs(sampler_mod, qmodel.head_dim, [(256, 256)] * BATCH, gen)
    rel_int8 = rel_rms(guided_forward(qmodel, inputs), guided_forward(qmodel, inputs, plain=True))
    del qmodel
    # the equalized bf16 model (the same calibration as cli.quantize's) against the loaded one
    rng = np.random.default_rng(0)
    calib = [synthetic_calib_batch(loaded, rng, batch=4, size=256) for _ in range(2)]
    eq_model = create_fit("FiT-XL/2", dtype=torch.bfloat16, device="cuda")
    eq_model.load_state_dict(equalize_params(loaded.state_dict(), calibrate(loaded, calib)))
    eq_model, loaded = (sampler_mod.cast_for_sampling(m, cuda) for m in (eq_model, loaded))
    rel_eq = rel_rms(guided_forward(eq_model, inputs), guided_forward(loaded, inputs))
    del eq_model, loaded
    torch.cuda.empty_cache()
    print(f"cli.quantize: {quant_s:.2f} s, with --equalize 2 {quant_eq_s:.2f} s; int8 artifact "
          f"{art_bytes / 2**30:.3f} GiB; its guided int8 forward, K3/K4 vs plain: rel_rms {rel_int8:.3e}; the "
          f"equalized bf16 forward vs the unequalized one: rel_rms {rel_eq:.3e} (tol {FORWARD_REL_RMS:g})", flush=True)
    if not (rel_int8 <= FORWARD_REL_RMS and rel_eq <= FORWARD_REL_RMS):
        raise AssertionError("the equalized int8 artifact's forward disagrees")
    int8 = run_cli("cli.sample int8", cli_sample.main,
                   ["--checkpoint-path", str(art_eq), "--sampler", "dpm", "--device", "cuda",
                    "--output-dir", str(CLI_DIR / "int8_out")],
                   rope_attention_fwd=k1_run, adaln_quant=2 * k1_run, silu_mul_quant=k1_run)
    if len(int8["latents"]) != BATCH or not all(np.isfinite(x).all() for x in int8["latents"]):
        raise AssertionError("cli.sample from the int8 artifact: bad latents")
    print(f"cli.sample int8 artifact dpm batch {BATCH}: {int8['seconds'][0] / STEPS * 1e3:.2f} ms/step", flush=True)

    # 8d. serve through the CLI, in its own process
    served = serve_cli_phase(art_eq)
    for k, v in served["launches"].items():
        totals[k] = totals.get(k, 0) + v
    stats = served["stats"]
    print(
        f"cli.serve: int8 artifact, dpm {SERVE_STEPS} steps batch {SERVE_BATCH}: listening after "
        f"{served['ready_s']:.2f} s (load + warmup); {served['n']} requests in {stats['batches']} batches, "
        f"{served['wall']:.3f} s wall; latency p50 {stats['latency_p50_s'] * 1e3:.1f} ms p95 "
        f"{stats['latency_p95_s'] * 1e3:.1f} ms; occupancy {stats['occupancy']:.3f}; the repeated seed "
        f"bit-identical; exit 0 after SIGINT; its launches {served['launches']}",
        flush=True,
    )

    # 8e. pixels through the command line: a seeded SD-VAE checkpoint in both attention styles
    vae_dir = CLI_DIR / "vae"
    t0 = time.perf_counter()
    write_vae_dir(vae_dir)
    vae_write_s = time.perf_counter() - t0
    vae_cli_phase(kernel_modules, run_cli, common, vae_dir, dpm["latents"], mixed["latents"], art_eq, k1_run, totals,
                  vae_write_s)
    print(f"cli launches {totals}", flush=True)
    return totals


# 8e and 9: synthetic images, four aspect ratios (w, h); each resizes to at
# most 256^2 and at most 256 tokens at patch 2
IMAGE_SIZES = [(256, 256), (320, 192), (192, 320), (384, 256)]
VAE_SEED = 10


def seeded_vae_state(seed: int = VAE_SEED) -> dict:
    """The published SD-VAE's shapes with PyTorch's default init (Conv2d and
    Linear: weight and bias uniform in +-1/sqrt(fan_in); GroupNorm: weight
    1, bias 0), drawn on the CPU from ``seed``."""
    from fit_tpu_torch.vae import AutoencoderKL

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return AutoencoderKL(device="cpu").state_dict()


def write_vae_dir(vae_dir: Path) -> None:
    """The seeded SD-VAE as diffusers checkpoints: ``sd-vae-ft-ema.bin``
    with the Linear (new) mid-block attention and ``sd-vae-ft-mse.bin``, the
    same weights with the 1x1-convolution (old ldm) attention."""
    from fit_tpu_torch.vae.convert import to_diffusers_state_dict

    vae_dir.mkdir(parents=True, exist_ok=True)
    state = seeded_vae_state()
    torch.save(to_diffusers_state_dict(state, attn_style="new"), vae_dir / "sd-vae-ft-ema.bin")
    torch.save(to_diffusers_state_dict(state, attn_style="old"), vae_dir / "sd-vae-ft-mse.bin")


def png_pixels(path: Path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def uint8_steps(a: np.ndarray, b: np.ndarray) -> int:
    """The largest difference of two uint8 images, in steps."""
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def vae_cli_phase(kernel_modules, run_cli, common, vae_dir, dpm_latents, mixed_latents, art_eq, k1_run, totals,
                  vae_write_s) -> None:
    """8e: the command lines with ``--vae-checkpoint``. ``cli.sample`` dpm
    batch 8 writes PNGs within one uint8 step of the direct bf16 decode of
    the latents the same seed wrote without the flag, and packed over the
    four sizes each PNG at its own size; ``cli.demo`` on the int8 artifact
    writes the 512 x 1024 grid; ``cli.serve`` serves PNGs (12 requests, a
    repeated seed bit-identical, exit 0 on SIGINT); ``cli.preprocess`` runs
    as a process over a small image tree. Every run's launches asserted."""
    from fit_tpu_torch.cli import demo as cli_demo
    from fit_tpu_torch.cli import sample as cli_sample
    from fit_tpu_torch.data.preprocess import resize_dims
    from fit_tpu_torch.vae import load_autoencoder, to_uint8

    t0 = time.perf_counter()
    vae = load_autoencoder(str(vae_dir), "ema", dtype=torch.bfloat16, device="cuda")
    load_s = time.perf_counter() - t0
    old_style = load_autoencoder(str(vae_dir), "mse", dtype=torch.bfloat16, device="cuda").state_dict()
    if any(not torch.equal(v, old_style[k]) for k, v in vae.state_dict().items()):
        raise AssertionError("the two attention styles of one checkpoint loaded different weights")
    del old_style
    size = sum(f.stat().st_size for f in vae_dir.glob("*.bin")) / 2 / 2**20
    print(f"cli vae: seeded SD-VAE (83.65 M parameters) written as two diffusers .bin of {size:.1f} MiB (Linear and "
          f"1x1-conv attention) in {vae_write_s:.2f} s; load_autoencoder {load_s:.2f} s; both styles load the same "
          f"weights", flush=True)

    out = CLI_DIR / "png"
    res = run_cli("cli.sample dpm --vae-checkpoint", cli_sample.main,
                  common + ["--sampler", "dpm", "--vae-checkpoint", str(vae_dir), "--output-dir", str(out)],
                  rope_attention_fwd=k1_run, **float_glue(STEPS))
    files = sorted(out.glob("generated_image_*.png"), key=lambda f: int(f.name.split("_")[2]))
    if len(files) != BATCH or not all(np.array_equal(a, b) for a, b in zip(dpm_latents, res["latents"])):
        raise AssertionError(f"cli.sample --vae-checkpoint: {len(files)} PNGs; its latents differ from the dpm run's")
    with torch.inference_mode():
        direct = to_uint8(vae.decode(torch.from_numpy(np.stack(dpm_latents)).cuda()))
    steps = max(uint8_steps(png_pixels(f), d) for f, d in zip(files, direct))
    if steps > 1 or any(png_pixels(f).shape != (256, 256, 3) for f in files):
        raise AssertionError(f"cli.sample's PNGs are {steps} uint8 steps from the direct decode")
    sizes = ",".join(f"{h}x{w}" for h, w in MIXED_SIZES)
    out_mixed = CLI_DIR / "png_mixed"
    packed = run_cli("cli.sample ddim mixed --vae-checkpoint", cli_sample.main,
                     common + ["--sampler", "ddim", "--image-sizes", sizes, "--vae-checkpoint", str(vae_dir),
                               "--output-dir", str(out_mixed)], rope_attention_fwd=k1_run, **float_glue(STEPS))
    mixed_files = sorted(out_mixed.glob("generated_image_*.png"), key=lambda f: int(f.name.split("_")[2]))
    want = [(MIXED_SIZES[i % 4][0], MIXED_SIZES[i % 4][1], 3) for i in range(BATCH)]
    if [png_pixels(f).shape for f in mixed_files] != want:
        raise AssertionError(f"cli.sample --image-sizes PNGs: {[png_pixels(f).shape for f in mixed_files]}")
    with torch.inference_mode():
        mixed_steps = max(uint8_steps(png_pixels(f), to_uint8(vae.decode(torch.from_numpy(lat)[None].cuda()))[0])
                          for f, lat in zip(mixed_files, mixed_latents))
    if mixed_steps > 1:
        raise AssertionError(f"cli.sample --image-sizes PNGs are {mixed_steps} uint8 steps from the direct decode")
    print(f"cli.sample --vae-checkpoint: dpm batch {BATCH} 256x256 -> {len(files)} PNGs, latents bit-identical to "
          f"the dpm run's, PNGs within {steps} uint8 step(s) of the direct bf16 decode of its latents; decode "
          f"{res['decode_seconds'][0] * 1e3:.1f} ms for the batch (host clock to the read-back); packed over {sizes}: "
          f"each PNG at its size, within {mixed_steps} step(s), decodes {packed['decode_seconds'][0] * 1e3:.1f} ms "
          f"(one per sample)", flush=True)
    del vae

    grid_path = CLI_DIR / "demo.png"
    run_cli("cli.demo --vae-checkpoint", cli_demo.main,
            ["--checkpoint_path", str(art_eq), "--model", "FiT-XL/2", "--num_sampling_steps", str(STEPS),
             "--image_size", "256", "--out", str(grid_path), "--vae-checkpoint", str(vae_dir / "sd-vae-ft-ema.bin"),
             "--device", "cuda"],
            rope_attention_fwd=k1_run, adaln_quant=2 * k1_run, silu_mul_quant=k1_run)
    grid = png_pixels(grid_path)
    if grid.shape != (512, 1024, 3):
        raise AssertionError(f"cli.demo grid {grid.shape}")

    served = serve_cli_phase(art_eq, vae_dir)
    for k, v in served["launches"].items():
        totals[k] = totals.get(k, 0) + v
    stats = served["stats"]

    imgs, lat_dir = CLI_DIR / "imgs", CLI_DIR / "latents"
    shapes = write_image_tree(imgs, 8, seed=3)
    _, pre_s = run_module("fit_tpu_torch.cli.preprocess", ["--dataset-path", imgs, "--latent-folder", lat_dir,
                                                           "--vae-checkpoint", vae_dir, "--batch-size", 4,
                                                           "--device", "cuda"], "cli.preprocess")
    got = {str(p.relative_to(lat_dir)): np.load(p) for p in lat_dir.rglob("*.npy")}
    want = {k: (4, resize_dims(w, h)[1] // 8, resize_dims(w, h)[0] // 8) for k, (w, h) in shapes.items()}
    if {k: v.shape for k, v in got.items()} != want or not (lat_dir / "path.json").exists():
        raise AssertionError(f"cli.preprocess wrote {sorted((k, v.shape) for k, v in got.items())}, expected {want}")
    if not all(v.dtype == np.float16 and np.isfinite(v).all() for v in got.values()):
        raise AssertionError("cli.preprocess wrote non-finite or non-fp16 latents")
    print(
        f"cli.demo --vae-checkpoint (int8 artifact, bf16 decode): a {grid.shape[0]}x{grid.shape[1]} grid; cli.serve "
        f"--vae-checkpoint: {served['n']} requests in {stats['batches']} batches, every body an image/png of its size, "
        f"latency p50 {stats['latency_p50_s'] * 1e3:.1f} ms p95 {stats['latency_p95_s'] * 1e3:.1f} ms, listening after "
        f"{served['ready_s']:.2f} s, the repeated seed bit-identical, exit 0 after SIGINT, launches "
        f"{served['launches']}; cli.preprocess (a process): {len(got)} images -> fp16 latents of resize_dims / 8 in "
        f"{pre_s:.2f} s (start-up, load and build included)",
        flush=True,
    )


def write_image_tree(root: Path, n: int, seed: int, sizes=IMAGE_SIZES) -> dict:
    """``n`` smooth random RGB PNGs in two class folders, cycling over
    ``sizes`` ((w, h) pairs). Returns {relative latent path: (w, h)}."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    shapes = {}
    for i in range(n):
        w, h = sizes[i % len(sizes)]
        coarse = rng.integers(0, 256, size=(h // 32 + 1, w // 32 + 1, 3), dtype=np.uint8)
        img = np.asarray(Image.fromarray(coarse).resize((w, h), resample=Image.BICUBIC), dtype=np.int16)
        img = np.clip(img + rng.integers(-8, 9, size=img.shape), 0, 255).astype(np.uint8)
        rel = Path(f"class{i % 2}") / f"{i}.png"
        (root / rel.parent).mkdir(parents=True, exist_ok=True)
        Image.fromarray(img).save(root / rel)
        shapes[str(rel.with_suffix(".npy"))] = (w, h)
    return shapes


# 9. pixels: the published SD-VAE at full width (83.65 M parameters, seeded
# with PyTorch's default init) decoding phases 4 and 7's latents and
# encoding synthetic images through preprocess_folder; then the Trainer on
# those latents, the Trainer with ffn="mlp", and a learn_sigma loss
PIXELS_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_pixels"
VAE_REL_RMS = 5e-2  # bf16 against fp32, decode and encode: the guided bf16 forwards' bar
ENCODE_IMAGES = 64
PIXEL_BATCH, PIXEL_ACCUM, PIXEL_STEPS = 32, 2, 2  # a stated cut: 64 latents, global batch 32 = 2 x 16, 2 steps
MLP_STEPS = 3


def write_train_latents(root: Path) -> None:
    """Phase 6's synthetic latents: 512 fp16 latents of TRAIN_LATENTS's four
    shapes in two classes, from numpy seed 0."""
    rng = np.random.default_rng(0)
    for i in range(512):
        d = root / f"class{i % 2}"
        d.mkdir(parents=True, exist_ok=True)
        np.save(d / f"{i}.npy", rng.normal(size=TRAIN_LATENTS[i % 4]).astype(np.float16))


def timed_runs(fn, runs: int = 3):
    """``fn()`` once to warm up, then ``runs`` times, each ended by a
    synchronize. Returns the last output, the median seconds and the peak
    memory allocated above what was allocated before the timed runs."""
    fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, float(np.median(times)), torch.cuda.max_memory_allocated() - base


def vae_flops(vae, fn) -> float:
    """The floating-point operations of ``fn()`` through ``vae``'s
    convolutions, linear layers and the two attention products, counted by
    forward hooks on one run (2 per multiply-add)."""
    from fit_tpu_torch.vae.model import AttnBlock, Conv, Dense

    total = [0.0]

    def conv(mod, _inp, out):
        total[0] += 2.0 * out.numel() * mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]

    def dense(mod, _inp, out):
        total[0] += 2.0 * out.numel() * mod.in_features

    def attn(_mod, inp, _out):
        n, c, h, w = inp[0].shape
        total[0] += 4.0 * n * (h * w) ** 2 * c

    hooks = [m.register_forward_hook({Conv: conv, Dense: dense, AttnBlock: attn}[type(m)])
             for m in vae.modules() if type(m) in (Conv, Dense, AttnBlock)]
    try:
        with torch.inference_mode():
            fn()
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def train_run(kernel_modules, work: Path, name: str, feature_path: Path, global_batch: int, accum: int,
              max_steps: int, **kw):
    """The Trainer, FiT-B/2 bf16, pad packing (remat on), for ``max_steps``
    steps with every launch count set to 0 just before; asserts the counts
    (K1 twice a block a micro-batch under remat, K2 once). Returns the
    counts, each step's seconds from the metrics clock and the losses."""
    from fit_tpu_torch.train.loop import Trainer
    from fit_tpu_torch.utils.config import TrainConfig

    cfg = TrainConfig(feature_path=str(feature_path), feature_val_path="", results_dir=str(work / name),
                      model="FiT-B/2", global_batch_size=global_batch, grad_accum=accum, compute_dtype="bfloat16",
                      packing="pad", log_every=1, ckpt_every_epochs=100, num_workers=4, **kw)
    trainer = Trainer(cfg)
    for mod in kernel_modules:
        mod.reset_launches()
    state = trainer.fit(max_steps=max_steps)
    torch.cuda.synchronize()
    counts = kernel_launches(*kernel_modules)
    expect_launches(f"trainer {name}", counts, rope_attention_fwd=2 * B2_DEPTH * accum * max_steps,
                    rope_attention_bwd=B2_DEPTH * accum * max_steps)
    with open(work / name / "FiT-B-2_metrics.jsonl") as f:
        recs = {r["step"]: r for r in map(json.loads, f) if "train_loss" in r}
    if state.step != max_steps or sorted(recs) != list(range(1, max_steps + 1)):
        raise AssertionError(f"trainer {name}: step {state.step}, logged {sorted(recs)}")
    losses = [recs[s]["train_loss"] for s in sorted(recs)]
    if not np.isfinite(losses).all():
        raise AssertionError(f"trainer {name}: losses {losses}")
    secs = [recs[s]["time"] - recs[s - 1]["time"] for s in range(2, max_steps + 1)]
    return counts, secs, losses, trainer


def learn_sigma_check(kernel_modules) -> None:
    """One FiT-B/2 bf16 learn_sigma training loss (LEARNED_RANGE,
    rescale_learned_sigmas: RESCALED_MSE, mse + vb) forward and backward
    on a 64 x 4 x 32 x 32 batch (T 256), through the kernels and through
    their plain versions, on the same weights, inputs and noise, at phase
    6's bars; the kernel run's launches asserted."""
    from fit_tpu_torch.core.pos_embed import rope_freqs_2d
    from fit_tpu_torch.diffusion.gaussian import create_diffusion
    from fit_tpu_torch.models.fit import create_fit

    gen = torch.Generator(device="cuda").manual_seed(11)
    model = create_fit("FiT-B/2", dtype=torch.bfloat16, learn_sigma=True, device="cuda")
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=gen)
    n = TRAIN_BATCH // TRAIN_ACCUM
    x0 = torch.randn((n, 4, 32, 32), generator=gen, device="cuda")
    noise = torch.randn((n, 4, 32, 32), generator=gen, device="cuda")
    t = torch.randint(0, 1000, (n,), generator=gen, device="cuda")
    y = torch.randint(0, 1000, (n,), generator=gen, device="cuda")
    pos = torch.from_numpy(rope_freqs_2d(model.head_dim, 16, 16)).cuda().expand(n, -1, -1).contiguous()
    lengths = torch.full((n,), 256, dtype=torch.int32, device="cuda")
    diffusion = create_diffusion(None, learn_sigma=True, rescale_learned_sigmas=True)

    def run(plain):
        model.plain_kernels = plain
        model.zero_grad(set_to_none=True)
        for mod in kernel_modules:
            mod.reset_launches()
        terms = diffusion.training_losses(
            lambda x, ts: model(x, ts, y, pos, None, train=False, lengths=lengths), x0, t, noise)
        loss = terms["loss"].mean()
        loss.backward()
        torch.cuda.synchronize()
        grad = torch.cat([p.grad.flatten().float() for p in model.parameters()])
        return loss.item(), terms["vb"].mean().item(), grad, kernel_launches(*kernel_modules)

    try:
        (loss_k, vb_k, g_k, counts), (loss_p, vb_p, g_p, plain_counts) = run(False), run(True)
    finally:
        model.plain_kernels = False
    expect_launches("learn_sigma loss, kernels", counts, rope_attention_fwd=B2_DEPTH, rope_attention_bwd=B2_DEPTH)
    expect_launches("learn_sigma loss, plain", plain_counts)
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    cos = torch.nn.functional.cosine_similarity(g_k, g_p, dim=0).item()
    norm_rel = abs(g_k.norm().item() - g_p.norm().item()) / g_p.norm().item()
    loss_tol, min_cos, norm_tol = STEP_BARS[torch.bfloat16]
    print(
        f"learn_sigma loss (RESCALED_MSE: mse + vb), FiT-B/2 bf16 {n} x 4 x 32 x 32, kernels vs plain: loss "
        f"{loss_k:.6f} vs {loss_p:.6f} rel {rel_loss:.3e} (tol {loss_tol:g}; vb {vb_k:.6f} vs {vb_p:.6f}); grad "
        f"cosine {cos:.6f} (min {min_cos:g}); grad norm {g_k.norm().item():.6f} vs {g_p.norm().item():.6f} rel "
        f"{norm_rel:.3e} (tol {norm_tol:g}), max |grad diff| {(g_k - g_p).abs().max().item():.3e}; launches "
        f"{ {k: v for k, v in counts.items() if v} }",
        flush=True,
    )
    if not (rel_loss <= loss_tol and cos >= min_cos and norm_rel <= norm_tol and np.isfinite(loss_k)):
        raise AssertionError("the learn_sigma loss through the kernels disagrees with the plain one")


# the decode's device activities by kind, from their kernel names
DECODE_GROUPS = (
    ("layout transforms (NCHW <-> NHWC)", ("nchwtonhwc", "nhwctonchw", "nchw2nhwc", "nhwc2nchw")),
    ("convolutions", ("conv", "xmma", "implicit", "cudnn", "sm90_")),
    ("group norm", ("group_norm", "groupnorm")),
    ("attention matmuls", ("gemm", "nvjet", "cutlass")),
    ("softmax", ("softmax",)),
)


def decode_profile(vae, latents) -> None:
    """One decode of ``latents`` under torch.profiler: device time by kind
    and the five costliest kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        vae.decode(latents)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=acts) as prof:
            vae.decode(latents)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.name] = by_kernel.get(evt.name, 0.0) + evt.time_range.elapsed_us() / 1e3
    by_group = {}
    for name, ms in by_kernel.items():
        low = name.lower()
        group = next((g for g, keys in DECODE_GROUPS if any(k in low for k in keys)), "elementwise and copies")
        by_group[group] = by_group.get(group, 0.0) + ms
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
    print(f"vae decode profile, bf16 {tuple(latents.shape)}: device {sum(by_kernel.values()):.2f} ms (host clock "
          f"{wall * 1e3:.2f} ms, CUPTI on); " + ", ".join(f"{g} {v:.2f}" for g, v in sorted(by_group.items(),
                                                                                          key=lambda kv: -kv[1]))
          + "; top kernels: " + "; ".join(f"{n[:70]} {v:.2f}" for n, v in top), flush=True)


def pixels_phase(kernel_modules, smi, fit_latents, fit_mixed, dit_latents):
    """Phase 9. Returns the launch counts of its main path (the two Trainer
    runs) and deletes what it wrote under build/."""
    shutil.rmtree(PIXELS_DIR, ignore_errors=True)
    PIXELS_DIR.mkdir(parents=True)
    try:
        return _pixels_phase(kernel_modules, smi, fit_latents, fit_mixed, dit_latents)
    finally:
        shutil.rmtree(PIXELS_DIR, ignore_errors=True)


def _pixels_phase(kernel_modules, smi, fit_latents, fit_mixed, dit_latents):
    from fit_tpu_torch.data.preprocess import preprocess_folder, resize_dims
    from fit_tpu_torch.models.layers import GeluMlp
    from fit_tpu_torch.vae import AutoencoderKL

    print(f"phase 9 on: {smi}; TF32 for matmuls {torch.backends.cuda.matmul.allow_tf32}, for cuDNN "
          f"{torch.backends.cudnn.allow_tf32} (fp32 runs at the fp32 rate)", flush=True)
    state = seeded_vae_state()
    vaes = {}
    for dtype in (torch.bfloat16, torch.float32):
        vaes[dtype] = AutoencoderKL(dtype=dtype, device="cuda").eval()
        vaes[dtype].load_state_dict(state)
    del state

    # 9a. decode, bf16 and fp32
    cases = [
        ("FiT-XL/2 256^2 (phase 4), batch 8", [fit_latents]),
        ("FiT-XL/2 four sizes (phase 4), one decode per shape", [lat[None] for lat in fit_mixed]),
        ("DiT-XL/2 512^2 (phase 7), batch 8", [dit_latents]),
    ]
    for name, groups in cases:
        n = sum(g.shape[0] for g in groups)
        outs, line = {}, []
        flops = vae_flops(vaes[torch.float32], lambda: [vaes[torch.float32].decode(g) for g in groups])
        for dtype, vae in vaes.items():
            with torch.inference_mode():
                out, sec, peak = timed_runs(lambda: [vae.decode(g) for g in groups])
            outs[dtype] = out
            peak_rate = PEAK_FLOPS[torch.bfloat16] if dtype == torch.bfloat16 else FP32_FMA_FLOPS
            line.append(f"{str(dtype).split('.')[1]} {sec * 1e3:.2f} ms ({n / sec:.2f} img/s, {flops / sec / 1e12:.1f} "
                        f"TFLOP/s, bound {flops / peak_rate * 1e3:.2f} ms by operations), peak {peak / 2**30:.2f} GiB")
        for o, g in zip(outs[torch.float32], groups):
            want = (g.shape[0], 3, 8 * g.shape[2], 8 * g.shape[3])
            if tuple(o.shape) != want or not torch.isfinite(o).all():
                raise AssertionError(f"decode {name}: {tuple(o.shape)}, expected {want}")
        rel = max(rel_rms(b.float(), f) for b, f in zip(outs[torch.bfloat16], outs[torch.float32]))
        print(f"vae decode {name}: {flops / 1e12:.3f} TFLOP; " + "; ".join(line)
              + f"; bf16 vs fp32 rel_rms {rel:.3e} (tol {VAE_REL_RMS:g})", flush=True)
        if not rel <= VAE_REL_RMS:
            raise AssertionError(f"the bf16 decode of {name} disagrees with the fp32 one")
        del outs
    decode_profile(vaes[torch.bfloat16], fit_latents)

    # 9b. encode, fp32 (preprocessing's dtype), through preprocess_folder
    imgs, lat_dir = PIXELS_DIR / "imgs", PIXELS_DIR / "latents"
    shapes = write_image_tree(imgs, ENCODE_IMAGES, seed=9)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    written = preprocess_folder(str(imgs), str(lat_dir), vaes[torch.float32], batch_size=16, progress=False)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    got = {str(Path(p).relative_to(lat_dir)): np.load(p) for p in written}
    want = {k: (4, resize_dims(w, h)[1] // 8, resize_dims(w, h)[0] // 8) for k, (w, h) in shapes.items()}
    if {k: v.shape for k, v in got.items()} != want or not all(np.isfinite(v).all() for v in got.values()):
        raise AssertionError(f"preprocess_folder wrote {sorted((k, v.shape) for k, v in got.items())}")
    rerun = preprocess_folder(str(imgs), str(lat_dir), vaes[torch.float32], batch_size=16, progress=False)
    if rerun:
        raise AssertionError(f"a rerun of preprocess_folder wrote {len(rerun)} latents")
    batch = np.random.default_rng(1).uniform(-1, 1, size=(16, 3, 256, 256)).astype(np.float32)
    x = torch.from_numpy(batch).cuda()
    enc_flops = vae_flops(vaes[torch.float32], lambda: vaes[torch.float32].encode_mode(x))
    encoded, enc_line = {}, []
    for dtype, vae in vaes.items():
        with torch.inference_mode():
            encoded[dtype], sec, peak = timed_runs(lambda: vae.encode_mode(x))
        enc_line.append(f"{str(dtype).split('.')[1]} {sec / 16 * 1e3:.3f} ms/image ({enc_flops / sec / 1e12:.1f} "
                        f"TFLOP/s), peak {peak / 2**30:.2f} GiB")
    rel_enc = rel_rms(encoded[torch.bfloat16].float(), encoded[torch.float32])
    print(f"vae encode: preprocess_folder (fp32, batch 16, {len(IMAGE_SIZES)} shapes) {len(written)} images in "
          f"{pre_s:.3f} s, {pre_s / len(written) * 1e3:.2f} ms/image (PIL load, bicubic resize and .npy writes "
          f"included); latents resize_dims / 8, a rerun wrote nothing; encode_mode 16 x 256^2 alone, "
          f"{enc_flops / 16 / 1e12:.3f} TFLOP/image: " + "; ".join(enc_line)
          + f"; bf16 vs fp32 rel_rms {rel_enc:.3e} (tol {VAE_REL_RMS:g})", flush=True)
    if not rel_enc <= VAE_REL_RMS:
        raise AssertionError("the bf16 encode disagrees with the fp32 one")
    del vaes, encoded, x
    torch.cuda.empty_cache()

    # 9c. the Trainer on exactly those latents
    counts, secs, losses, trainer = train_run(kernel_modules, PIXELS_DIR, "from_pixels", lat_dir, PIXEL_BATCH,
                                              PIXEL_ACCUM, PIXEL_STEPS)
    del trainer
    gc.collect()
    totals = dict(counts)
    print(f"trainer on the preprocessed latents: FiT-B/2 bf16, global batch {PIXEL_BATCH} = {PIXEL_ACCUM} x "
          f"{PIXEL_BATCH // PIXEL_ACCUM}, {PIXEL_STEPS} steps: loss {', '.join(f'{v:.6f}' for v in losses)}; step 2 "
          f"{secs[0] * 1e3:.2f} ms; launches {counts}", flush=True)

    # 9d. ffn="mlp" on phase 6's synthetic latents, then a learn_sigma loss
    write_train_latents(PIXELS_DIR / "train_latents")
    torch.cuda.reset_peak_memory_stats()
    counts, secs, losses, trainer = train_run(kernel_modules, PIXELS_DIR, "mlp", PIXELS_DIR / "train_latents",
                                              TRAIN_BATCH, TRAIN_ACCUM, MLP_STEPS, ffn="mlp")
    peak = torch.cuda.max_memory_allocated()
    if not all(isinstance(blk.ffn, GeluMlp) for blk in trainer.model.blocks):
        raise AssertionError("the ffn='mlp' Trainer built other blocks")
    del trainer
    gc.collect()
    for k, v in counts.items():
        totals[k] += v
    step_s = float(np.median(secs))
    print(f"trainer ffn=mlp: FiT-B/2 bf16 256^2 pad packing, global batch {TRAIN_BATCH} = {TRAIN_ACCUM} x "
          f"{TRAIN_BATCH // TRAIN_ACCUM}, remat: {step_s * 1e3:.2f} ms per optimizer step (median of steps 2-"
          f"{MLP_STEPS}: {', '.join(f'{x * 1e3:.2f}' for x in secs)}), {TRAIN_BATCH / step_s:.2f} img/s, "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; loss {', '.join(f'{v:.6f}' for v in losses)}; launches "
          f"{counts}", flush=True)
    torch.cuda.empty_cache()
    learn_sigma_check(kernel_modules)
    return totals


# 10. eval: FiT-XL/2 samples -> PNGs -> InceptionV3 features -> FID, sFID,
# IS and Precision/Recall, as processes, on a seeded full-width InceptionV3
# (pytorch-fid's module names, 1008-way fc); the card's features against
# the CPU's, feature throughput against its bound, the MFU of phases 4 and 6
# from utils/flops.py, and the native packer against the numpy loader
EVAL_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_eval"
EVAL_IMAGES = 64  # samples, reference images, and the throughput batch
INCEPTION_SEED = 11
EVAL_FEATURE_REL = 1e-4  # card vs CPU: max abs error over max |CPU|, fp32 with TF32 off
EVAL_COMPARE = 8  # images in the card-vs-CPU check, at 256^2 and 512^2
FID_IMAGES = 50_000  # a FID run's sample count
LOADER_BATCHES = 16  # four epochs of phase 6's 512 latents at batch 128, a timed run
LOADER_REPEATS = 3  # timed runs a path, native and numpy alternating
SUBPROCESS_S = 600
_METRIC_LINES = {
    "FID": r"^FID: (\S+)$", "sFID": r"^sFID: (\S+)$", "IS": r"^Inception Score: (\S+) \+/- (\S+)$",
    "PR": r"^Precision: (\S+)  Recall: (\S+)$",
}


def seeded_inception_state(seed: int = INCEPTION_SEED, num_classes: int = 1008) -> dict:
    """A full-width InceptionV3 state dict with pytorch-fid's module names
    (``<conv>.conv.weight``, ``<conv>.bn.*``, ``fc.*``) and a
    ``num_classes``-way fc, drawn on the host from numpy seed ``seed``:
    He-normal convolutions and BatchNorm near identity, as
    ``tests/test_inception.py``'s fake state dict draws them."""
    from fit_tpu_torch.eval.inception import InceptionV3

    with torch.device("meta"):
        convs = {n: tuple(m.weight.shape) for n, m in InceptionV3().named_modules() if isinstance(m, torch.nn.Conv2d)}
    rng = np.random.default_rng(seed)
    sd = {}
    for name, (o, i, kh, kw) in convs.items():
        sd[f"{name}.conv.weight"] = rng.normal(size=(o, i, kh, kw)) * np.sqrt(2.0 / (i * kh * kw))
        sd[f"{name}.bn.weight"] = 1.0 + 0.1 * rng.normal(size=(o,))
        sd[f"{name}.bn.bias"] = 0.05 * rng.normal(size=(o,))
        sd[f"{name}.bn.running_mean"] = 0.05 * rng.normal(size=(o,))
        sd[f"{name}.bn.running_var"] = rng.uniform(0.5, 1.5, size=(o,))
    sd["fc.weight"] = rng.normal(size=(num_classes, 2048)) * 0.02
    sd["fc.bias"] = 0.01 * rng.normal(size=(num_classes,))
    return {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()}


def inception_flops(model) -> float:
    """The floating-point operations of one image through the network's
    convolutions and fc head (2 per multiply-add), counted by forward hooks
    on one pass at 299^2 on the model's device; the resize and the pools
    are left out (bytes, not operations)."""
    total = [0.0]

    def conv(mod, _inp, out):
        total[0] += 2.0 * out.numel() * (mod.in_channels // mod.groups) * mod.kernel_size[0] * mod.kernel_size[1]

    def dense(mod, _inp, out):
        total[0] += 2.0 * out.numel() * mod.in_features

    hooks = [m.register_forward_hook(conv if isinstance(m, torch.nn.Conv2d) else dense)
             for m in model.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        with torch.inference_mode():
            x = torch.zeros((1, 3, 299, 299), device=model.Conv2d_1a_3x3.weight.device)
            model.logits(model(x)[0])
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def fit_mfu(step_s: float, flops: float, dtype: str = "bfloat16") -> "tuple[float | None, float | None]":
    """(MFU, the peak it divides by) of ``flops`` done in ``step_s`` on this
    card, from ``fit_tpu_torch.utils.flops``; (None, None) for a card the
    peak table does not know."""
    from fit_tpu_torch.utils.flops import peak_flops

    peak = peak_flops(torch.cuda.get_device_name(0), dtype)
    return (flops / step_s / peak, peak) if peak else (None, None)


def run_module(module: str, args, what: str) -> "tuple[str, float]":
    """``python -m <module> <args>`` from the repository's root; its stdout
    and seconds on the host clock. Raises if it exits with another code than 0."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *map(str, args)], cwd=Path(__file__).resolve().parent,
                          capture_output=True, text=True, timeout=SUBPROCESS_S)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{what} exited {proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    return proc.stdout, secs


def parse_metric_lines(out: str) -> dict:
    """cli.fid's printed metrics -> {"FID": [x], "sFID": [x], "IS": [mean, std],
    "PR": [precision, recall]}, for the lines present."""
    found = {}
    for key, pattern in _METRIC_LINES.items():
        m = re.search(pattern, out, re.M)
        if m:
            found[key] = [float(g) for g in m.groups()]
    return found


def eval_phase(kernel_modules, smi, sample_step_ms, train_step_s):
    """Phase 10. Needs phase 8's checkpoint and VAE under CLI_DIR. Returns
    the launch counts of its main path (the cli.sample process) and
    deletes what it wrote under build/."""
    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    EVAL_DIR.mkdir(parents=True)
    try:
        return _eval_phase(kernel_modules, smi, sample_step_ms, train_step_s)
    finally:
        shutil.rmtree(EVAL_DIR, ignore_errors=True)


def _eval_phase(kernel_modules, smi, sample_step_ms, train_step_s):
    import scipy

    from fit_tpu_torch.data.dataset import LatentFolderDataset, LatentLoader
    from fit_tpu_torch.data.native import get_lib
    from fit_tpu_torch.data.profile_loaders import profile_loader
    from fit_tpu_torch.eval.inception import convert_torch_inception, make_suite_extractor
    from fit_tpu_torch.utils.flops import fit_forward_flops

    print(f"phase 10 on: {smi}; scipy {scipy.__version__} on the card's host (frechet_distance's sqrtm); "
          f"TF32 off in the Inception forward", flush=True)
    # 10a. the seeded Inception as a .pth, and a reference tree of 256^2 images
    state = seeded_inception_state()
    weights = EVAL_DIR / "pt_inception_seeded.pth"
    torch.save(state, weights)
    ref_dir, samples, stats = EVAL_DIR / "reference", EVAL_DIR / "samples", EVAL_DIR / "reference_stats.npz"
    write_image_tree(ref_dir, EVAL_IMAGES, seed=12, sizes=[(256, 256)])

    # 10b. cli.sample as a process: phase 8's FiT-XL/2 reference checkpoint (its EMA) and SD-VAE -> PNGs
    out, sample_s = run_module("fit_tpu_torch.cli.sample", [
        "--torch-checkpoint", CLI_DIR / "last.ckpt", "--model", "FiT-XL/2", "--sampler", "dpm",
        "--num-sampling-steps", STEPS, "--cfg-scale", CFG_SCALE, "--num-samples", EVAL_IMAGES,
        "--batch-size", EVAL_IMAGES, "--image-height", 256, "--image-width", 256,
        "--vae-checkpoint", CLI_DIR / "vae", "--output-dir", samples, "--device", "cuda"], "cli.sample")
    found = [line for line in out.splitlines() if line.startswith("[sample] kernel launches: ")]
    if not found:
        raise AssertionError(f"cli.sample printed no launch counts: {out[-2000:]}")
    launches = json.loads(found[-1].split(": ", 1)[1])
    expect_launches("cli.sample -> PNGs", launches, rope_attention_fwd=DEPTH * STEPS,
                    **float_glue(STEPS))  # one batch, one forward a step
    pngs = sorted(samples.glob("generated_image_*.png"))
    if len(pngs) != EVAL_IMAGES or any(png_pixels(f).shape != (256, 256, 3) for f in pngs):
        raise AssertionError(f"cli.sample wrote {len(pngs)} PNGs")
    batch_line = next(line for line in out.splitlines() if line.startswith("batch 1/1"))

    # 10c. cli.fid as processes: the reference's statistics, then the whole suite on the samples
    common = ["--inception-weights", weights, "--batch-size", EVAL_IMAGES, "--device", "cuda"]
    _, save_s = run_module("fit_tpu_torch.cli.fid", ["--samples-dir", ref_dir, "--save-stats", stats] + common,
                           "cli.fid --save-stats")
    saved = np.load(stats)
    if set(saved.files) != {"mu", "sigma", "feats", "mu_s", "sigma_s"} or saved["feats"].shape != (EVAL_IMAGES, 2048):
        raise AssertionError(f"cli.fid --save-stats wrote {saved.files}")
    out, metric_s = run_module("fit_tpu_torch.cli.fid", ["--samples-dir", samples, "--reference", stats,
                                                         "--metrics", "fid,sfid,is,pr"] + common, "cli.fid --metrics")
    metrics = parse_metric_lines(out)
    if set(metrics) != set(_METRIC_LINES) or not all(np.isfinite(v).all() for v in metrics.values()):
        raise AssertionError(f"cli.fid printed {metrics}: {out[-2000:]}")
    print(f"eval: cli.sample (a process) FiT-XL/2 dpm {STEPS} steps cfg {CFG_SCALE}, {EVAL_IMAGES} PNGs at 256^2 "
          f"through the SD-VAE in {sample_s:.2f} s ({batch_line.split(': ', 1)[1]}; start-up and the 5 GiB load "
          f"included), K1 launches {launches['rope_attention_fwd']}; cli.fid --save-stats on {EVAL_IMAGES} reference "
          f"images {save_s:.2f} s; cli.fid --metrics fid,sfid,is,pr {metric_s:.2f} s: FID {metrics['FID'][0]:.4f}, "
          f"sFID {metrics['sFID'][0]:.4f}, IS {metrics['IS'][0]:.4f} +/- {metrics['IS'][1]:.4f}, precision "
          f"{metrics['PR'][0]:.4f} recall {metrics['PR'][1]:.4f} (seeded Inception, random FiT weights: the numbers "
          f"show the path runs, not sample quality)", flush=True)

    # 10d. the card's features against the same module's CPU path
    model = convert_torch_inception(state)
    del state
    rng = np.random.default_rng(13)
    rels = {}
    for side in (256, 512):
        x = rng.uniform(size=(EVAL_COMPARE, 3, side, side)).astype(np.float32)
        want = make_suite_extractor(model, spatial=True, probs=True, device="cpu")(x)
        got = make_suite_extractor(model, spatial=True, probs=True, device="cuda")(x)
        for k in want:
            rels[(side, k)] = float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max())
    print("eval features, card vs CPU (fp32, TF32 off, variant fid, " + f"{EVAL_COMPARE} images): " + ", ".join(
        f"{side}^2 {k} {r:.3e}" for (side, k), r in rels.items()) + f" (max abs over max |CPU|, tol "
        f"{EVAL_FEATURE_REL:g})", flush=True)
    if not max(rels.values()) <= EVAL_FEATURE_REL:
        raise AssertionError("the card's Inception features disagree with the CPU's")

    # 10e. feature throughput at batch 64: one trunk pass for pool3, spatial and the fc head, as cli.fid runs it
    card = model.cuda()
    flops_img = inception_flops(card)
    bound_s = flops_img * EVAL_IMAGES / FP32_FMA_FLOPS
    gen = torch.Generator(device="cuda").manual_seed(14)
    rates = {}
    for side in (256, 512):
        x = torch.rand((EVAL_IMAGES, 3, side, side), device="cuda", generator=gen)
        with torch.inference_mode():
            _, sec, peak = timed_runs(lambda: card.logits(card(x, "fid", spatial=True)[0]), runs=5)
        rates[side] = EVAL_IMAGES / sec
        print(f"eval features at batch {EVAL_IMAGES}, {side}^2 inputs (resize to 299^2 included): {sec * 1e3:.2f} ms "
              f"a batch, {rates[side]:.1f} img/s, {flops_img * EVAL_IMAGES / sec / 1e12:.2f} TFLOP/s; bound "
              f"{bound_s * 1e3:.2f} ms by operations ({flops_img / 1e9:.3f} GFLOP an image over {FP32_FMA_FLOPS / 1e12:.0f} TFLOP/s fp32; "
              f"{bound_s / sec:.1%} of it); peak {peak / 2**30:.2f} GiB above the weights; a {FID_IMAGES}-image FID "
              f"takes {FID_IMAGES / rates[side]:.1f} s of feature time on this card; {smi}", flush=True)
    del card, model
    torch.cuda.empty_cache()

    # 10f. MFU of phase 4's guided sampling step and phase 6's optimizer step
    fl_sample = fit_forward_flops(XL_HIDDEN, DEPTH, 16, t=256, batch=2 * BATCH)  # CFG: conditional and null rows
    mfu_sample, peak = fit_mfu(sample_step_ms / 1e3, fl_sample.total)
    fl_train = fit_forward_flops(768, B2_DEPTH, 12, t=256, batch=TRAIN_BATCH)
    train_flops = fl_train.total * 3  # model FLOPs: forward and backward (2x); recomputation is not counted
    mfu_train, _ = fit_mfu(train_step_s, train_flops)
    hfu_train, _ = fit_mfu(train_step_s, fl_train.total * 4)  # hardware FLOPs: remat's second forward too
    if mfu_sample is None:
        print(f"mfu: not measured ({torch.cuda.get_device_name(0)!r} is not in utils/flops.py's peak table)", flush=True)
    else:
        print(f"mfu (utils/flops.py, bf16 peak {peak / 1e12:.0f} TFLOP/s dense): phase 4's guided FiT-XL/2 256^2 DDIM "
              f"step at batch {BATCH} ({2 * BATCH} rows x T 256, {fl_sample.total / 1e12:.3f} TFLOP) in "
              f"{sample_step_ms:.2f} ms: mfu {mfu_sample:.4f}; phase 6's FiT-B/2 optimizer step, global batch "
              f"{TRAIN_BATCH} x T 256 with remat ({train_flops / 1e12:.3f} TFLOP = 3 x the forward's "
              f"{fl_train.total / 1e12:.3f}) in {train_step_s * 1e3:.2f} ms: mfu {mfu_train:.4f} (hfu {hfu_train:.4f} "
              f"counting remat's second forward, 4 x the forward); {smi}", flush=True)

    # 10g. the native packer against the numpy path on phase 6's synthetic latents
    lat_dir = EVAL_DIR / "latents"
    write_train_latents(lat_dir)
    t0 = time.perf_counter()
    lib = get_lib()
    build_s = time.perf_counter() - t0
    ds = LatentFolderDataset(str(lat_dir), head_dim=64)
    line = []
    for mode in ("pad", "bucket"):
        loaders = {native: LatentLoader(ds, TRAIN_BATCH, mode=mode, seed=3, native=native) for native in (True, False)}
        for a, b in zip(*(loaders[n].epoch_batches(0) for n in (True, False)), strict=True):
            if a.keys() != b.keys() or not all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a):
                raise AssertionError(f"the native packer's {mode} batches differ from the numpy path's")
        runs = {True: [], False: []}
        for _ in range(LOADER_REPEATS):
            for n in (True, False):
                runs[n].append(profile_loader(loaders[n], LOADER_BATCHES)["ms_per_batch"])
        ms = {n: float(np.median(v)) for n, v in runs.items()}
        ratios = [b / a for a, b in zip(runs[True], runs[False])]
        line.append(
            f"{mode} native {1e3 / ms[True]:.1f} batches/s ({ms[True]:.2f} ms, runs {min(runs[True]):.2f}-"
            f"{max(runs[True]):.2f}), numpy {1e3 / ms[False]:.1f} batches/s ({ms[False]:.2f} ms, runs "
            f"{min(runs[False]):.2f}-{max(runs[False]):.2f}), {ms[False] / ms[True]:.2f}x (runs {min(ratios):.2f}-"
            f"{max(ratios):.2f}x)")
    print(f"loader: phase 6's 512 fp16 latents, batch {TRAIN_BATCH}, {LOADER_REPEATS} runs of {LOADER_BATCHES} "
          f"batches a path through profile_loader, alternating, median ms a batch (the host's {os.cpu_count()} "
          f"cores, one epoch's bytes identical native vs numpy): "
          + "; ".join(line) + f"; the packer {Path(lib._name).relative_to(Path(__file__).resolve().parent)} "
          f"built or loaded in {build_s:.2f} s", flush=True)
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this check needs a CUDA card")
    from fit_tpu_torch import sampling as sampler_mod
    from fit_tpu_torch import serve as serve_mod
    from fit_tpu_torch.cli.serve import make_handler
    from fit_tpu_torch.core.pos_embed import rope_freqs_2d
    from fit_tpu_torch.models.fit import FiT, create_fit
    from fit_tpu_torch.ops import _build, fused_adaln, quant
    from fit_tpu_torch.ops import attention as attn
    from fit_tpu_torch.ops import rope_attention as ra

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build: one nvcc per source, started together
    sources = ("rope_attention", "rope_attention_bwd", "row_quant")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        for f in [pool.submit(ra._lib, "rope_attention"), pool.submit(ra._lib, "rope_attention_bwd"),
                  pool.submit(fused_adaln._lib)]:
            f.result()
    build_s = time.perf_counter() - t0
    for name in sources:
        ptxas = sorted({
            line.split("ptxas info    : ")[1]
            for log in _build.BUILD_DIR.glob(f"{name}_*.log")
            for line in log.read_text().splitlines()
            if "Used" in line and "registers" in line
        })
        print(f"build: {name}.cu; ptxas: {ptxas}", flush=True)
    print(f"build: {len(sources)} sources in {build_s:.2f} s", flush=True)
    logs = {name: "".join(log.read_text() for log in _build.BUILD_DIR.glob(f"{name}_*.log")) for name in sources}
    check_no_spill("bf16 K1 (mma.sync) (DP, RoPE)", mma_ptxas(logs["rope_attention"]),
                   lambda k: k[0] in NO_SPILL_DPS, 10)
    check_no_spill("fp32 K1 (3xTF32 mma.sync) (DP, RoPE)", tf32_ptxas(logs["rope_attention"]),
                   lambda k: k[0] in NO_SPILL_DPS, 10)
    check_no_spill("bf16 K2 (mma.sync) (pass, DP)", k2_mma_ptxas(logs["rope_attention_bwd"]),
                   lambda k: k[1] in NO_SPILL_DPS, 10)
    check_no_spill("fp32 K2 (3xTF32 mma.sync) (pass, DP)", k2_tf32_ptxas(logs["rope_attention_bwd"]),
                   lambda k: k[1] in NO_SPILL_DPS, 10)
    # every width of K3's warp path (to 1152, so every FiT and DiT width) must not spill
    check_no_spill("K3 adaln_warp_rows (dtype, quads per lane)", warp_rows_ptxas(logs["row_quant"]),
                   lambda k: True, 18)

    # 3. kernel vs plain, at the main path's shapes (XL: H=16, d=72; L: d=64)
    padded16 = PADDED16
    errs = []
    fwd_main = {}  # dtype -> device times at the first (the sampling) shape
    for h, d, t, lengths in [
        (16, 72, 256, padded16),  # 256^2 sampling, batch 8 with CFG
        (16, 72, 1024, [1024, 700]),  # 512^2 extrapolation
        (16, 64, 256, padded16),  # head dim of FiT-S/B/L
    ]:
        for dtype in (torch.bfloat16, torch.float32):
            first = len(errs) < 2
            res = attention_case(ra, rope_freqs_2d, h, d, t, lengths, dtype, seed=len(errs), yardstick=first)
            errs.append(res[0])
            if first:
                fwd_main[dtype] = res[3]

    # 3b. the row kernels and the int8 GEMM at XL serving shapes
    rows = row_kernel_cases()
    int8_gemm_line(quant)

    # 4. sampling: FiT-XL/2, seeded random weights, DDIM + CFG at 256^2
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = seeded_fit_xl(create_fit, gen)
    sampler = sampler_mod.FiTSampler(
        model, num_sampling_steps=STEPS, cfg_scale=CFG_SCALE, sampler="ddim", device="cuda"
    )
    rel_full = guided_forward_rel_rms(model, sampler_mod, model.head_dim, [(256, 256)] * BATCH, gen)
    rel_mixed = guided_forward_rel_rms(model, sampler_mod, model.head_dim, MIXED_SIZES, gen)
    print(f"guided forward kernel vs plain: rel_rms full={rel_full:.3e} mixed={rel_mixed:.3e} "
          f"(tol {FORWARD_REL_RMS:g})", flush=True)
    if not (rel_full <= FORWARD_REL_RMS and rel_mixed <= FORWARD_REL_RMS):
        raise AssertionError("the guided forward through the kernel disagrees with the plain one")

    labels = list(range(0, 1000, 1000 // BATCH))[:BATCH]
    kernel_modules = (ra, quant, fused_adaln, attn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in kernel_modules:
        mod.reset_launches()
    t0 = time.perf_counter()
    latents = sampler.sample(labels, 256, 256, generator=gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mixed = sampler.sample_mixed(labels[:4], MIXED_SIZES, generator=gen)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    sample_launches = kernel_launches(*kernel_modules)
    expected = {k: 0 for k in sample_launches}
    expected.update(rope_attention_fwd=DEPTH * STEPS * 2, **float_glue(STEPS * 2))  # sample and sample_mixed
    if sample_launches != expected:
        raise AssertionError(f"kernel launches on the sampling path {sample_launches}, expected {expected}")
    if tuple(latents.shape) != (BATCH, 4, 32, 32) or not torch.isfinite(latents).all():
        raise AssertionError(f"bad sample output: {tuple(latents.shape)}")
    want_shapes = [(4, ih // 8, iw // 8) for ih, iw in MIXED_SIZES]
    if [tuple(m.shape) for m in mixed] != want_shapes or not all(torch.isfinite(m).all() for m in mixed):
        raise AssertionError(f"bad sample_mixed output: {[tuple(m.shape) for m in mixed]}")
    step_ms = (t1 - t0) / STEPS * 1e3
    print(
        f"slice: FiT-XL/2 256x256 DDIM {STEPS} steps cfg {CFG_SCALE} batch {BATCH}: "
        f"{step_ms:.2f} ms/step, {BATCH / (t1 - t0):.3f} img/s; sample_mixed x4 "
        f"{(t2 - t1) / STEPS * 1e3:.2f} ms/step; kernel launches {sample_launches['rope_attention_fwd']} K1, "
        f"{sample_launches['adaln_modulate']} K5, {sample_launches['adaln_residual']} K5R, "
        f"{sample_launches['swiglu_glue']} K6; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
        flush=True,
    )

    # 5. int8: the same weights quantized; one guided forward checked, then served
    t0 = time.perf_counter()
    qmodel = sampler_mod.cast_for_sampling(quant.quantize_model(model), torch.device("cuda"))
    quant_s = time.perf_counter() - t0
    q32 = FiT(**{**qmodel.config, "dtype": torch.float32}, device="cuda")
    q32.load_state_dict(qmodel.state_dict())
    inputs = guided_inputs(sampler_mod, model.head_dim, [(256, 256)] * BATCH, gen)
    inputs_mixed = guided_inputs(sampler_mod, model.head_dim, MIXED_SIZES, gen)
    rel_block, block_floor = block_rel_rms(q32, ra, inputs, gen)
    rel_fp32 = [rel_rms(guided_forward(q32, i), guided_forward(q32, i, plain=True)) for i in (inputs, inputs_mixed)]
    nudged = (inputs[0] * (1 + INPUT_PERTURBATION), *inputs[1:])
    sensitivity = rel_rms(guided_forward(q32, nudged, plain=True), guided_forward(q32, inputs, plain=True))
    out_int8 = guided_forward(qmodel, inputs)
    rel_bf16 = rel_rms(out_int8, guided_forward(qmodel, inputs, plain=True))
    drift = rel_rms(out_int8, guided_forward(model, inputs))
    print(
        f"int8 forward: quantize_model {quant_s:.2f} s; kernels vs plain kernels rel_rms: one XL block fp32 "
        f"{rel_block:.3e} (tol {INT8_BLOCK_REL_RMS:g}; the plain block moves by {block_floor:.3e} for a "
        f"{BLOCK_PERTURBATION:g} input perturbation); whole forward fp32 full={rel_fp32[0]:.3e} "
        f"mixed={rel_fp32[1]:.3e}, bf16 full={rel_bf16:.3e} (tol {FORWARD_REL_RMS:g}; the plain fp32 "
        f"forward moves by {sensitivity:.3e} for a {INPUT_PERTURBATION:g} input perturbation); "
        f"int8 vs bf16 rel_rms={drift:.3e}",
        flush=True,
    )
    if not (rel_block <= INT8_BLOCK_REL_RMS and max(*rel_fp32, rel_bf16) <= FORWARD_REL_RMS):
        raise AssertionError("the int8 forward through the kernels disagrees with the plain one")
    int8_forward_profile(qmodel, inputs, quant, smi)
    del model, sampler, q32

    # the int8 sampler alone at batch 8, beside phase 4's bf16 step
    qsampler = sampler_mod.FiTSampler(
        qmodel, num_sampling_steps=STEPS, cfg_scale=CFG_SCALE, sampler="ddim", device="cuda"
    )
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qlatents = qsampler.sample(labels, 256, 256, generator=gen)
    torch.cuda.synchronize()
    int8_step_ms = (time.perf_counter() - t0) / STEPS * 1e3
    if tuple(qlatents.shape) != (BATCH, 4, 32, 32) or not torch.isfinite(qlatents).all():
        raise AssertionError(f"bad int8 sample output: {tuple(qlatents.shape)}")
    print(f"int8 sampler: FiT-XL/2 256x256 DDIM {STEPS} steps batch {BATCH}: {int8_step_ms:.2f} ms/step, "
          f"{BATCH / (int8_step_ms * STEPS / 1e3):.3f} img/s (bf16: {step_ms:.2f} ms/step)", flush=True)

    serve_launches = serve_phase(qmodel, serve_mod, make_handler, kernel_modules)
    del qmodel, qsampler
    torch.cuda.empty_cache()

    # 6. training: K1's lse and K2 against their plain versions, one FiT-B/2
    # step with kernels vs plain kernels, then the Trainer (pad, resume, bucket)
    grads = {}
    for i, (h, d, b, t, lengths) in enumerate(GRAD_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            grads[(i, dtype)] = attention_grad_case(
                ra, rope_freqs_2d, h, d, b, t, lengths, dtype, seed=100 + i,
                per_pass=i in K2_PASS_CASES,
            )
    for i, earlier in K2_EARLIER_US.items():
        h, d, b, t, lengths = GRAD_SHAPES[i]
        r = grads[(i, torch.bfloat16)]
        passes = ", ".join(
            f"{n} {r[f'bwd_{n}_ms'] * 1e3:.1f} (bound {r[f'bwd_{n}_bound_ms'] * 1e3:.1f} by {r[f'bwd_{n}_bound_by']})"
            for n in K2_PASSES if f"bwd_{n}_ms" in r
        )
        print(
            f"K2 bf16 (mma.sync) at B{b} T{t} H{h} d{d}: device us {r['bwd_ms'] * 1e3:.1f} (before it: {earlier})"
            f"{f'; passes alone, us: {passes}' if passes else ''}; bound {r['bwd_bound_ms'] * 1e3:.1f} by "
            f"{r['bwd_bound_by']}, SDPA bwd {r['sdpa_bwd_ms'] * 1e3:.1f}; {earlier / (r['bwd_ms'] * 1e3):.2f}x faster, "
            f"{r['bwd_ms'] / r['sdpa_bwd_ms']:.2f}x SDPA; {smi}",
            flush=True,
        )
    for i, earlier in FP32_K2_EARLIER_US.items():  # the fp32 K2 beside SDPA's fp32 backward
        h, d, b, t, lengths = GRAD_SHAPES[i]
        r = grads[(i, torch.float32)]
        us = r["bwd_ms"] * 1e3
        passes = ", ".join(
            f"{n} {r[f'bwd_{n}_ms'] * 1e3:.1f} (bound {r[f'bwd_{n}_bound_ms'] * 1e3:.1f} by {r[f'bwd_{n}_bound_by']})"
            for n in K2_PASSES
        )
        print(
            f"K2 fp32 (3xTF32 mma.sync) at B{b} T{t} H{h} d{d}: device us {us:.1f} (before it, FMA: {earlier}; "
            f"{earlier / us:.2f}x faster); passes alone, us: {passes}; plain {r['bwd_plain_ms'] * 1e3:.1f}, SDPA fp32 "
            f"bwd {r['sdpa_bwd_ms'] * 1e3:.1f} ({r['bwd_ms'] / r['sdpa_bwd_ms']:.2f}x SDPA's time); bound "
            f"{r['bwd_bound_ms'] * 1e3:.1f} by {r['bwd_bound_by']} (3xTF32 at 165 TFLOP/s; "
            f"{r['bwd_bound_ms'] / r['bwd_ms']:.1%} of it) and {r['bwd_fma_bound_ms'] * 1e3:.1f} at the FMA rate; {smi}",
            flush=True,
        )
    for dtype in (torch.bfloat16, torch.float32):
        train_step_check(ra, rope_freqs_2d, dtype)
    train_launches, fp32_train_k2, train_step_s = trainer_phase(kernel_modules, smi)
    bwd_main, bwd32 = grads[(0, torch.bfloat16)], grads[(0, torch.float32)]
    torch.cuda.empty_cache()

    # 7. DiT: K1's RoPE-off and strided modes against their plain versions,
    # DiT-XL/2 512^2 guided sampling, and the FiT absolute / MLP forward
    print(f"phase 7 on: {smi}", flush=True)
    strided = {}
    for i, (name, layout, h, d, t, lengths) in enumerate(STRIDED_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            strided[(i, dtype)] = strided_case(ra, attn, rope_freqs_2d, name, layout, h, d, t, lengths, dtype, 200 + i)
    torch.cuda.empty_cache()
    dit_launches, dit_latents = dit_phase(kernel_modules)
    torch.cuda.empty_cache()
    moe_cases, ditmoe_launches = ditmoe_phase(kernel_modules, smi)
    torch.cuda.empty_cache()
    fit_absolute_check(sampler_mod)

    def k1_at(dtype):
        """K1's device times at its three main-path shapes (phases 7a, 3, 6a)."""
        b2 = grads[(0, dtype)]
        return {
            "DiT-XL/2 512^2 B16 T1024 H16 d72 RoPE off": strided[(0, dtype)],
            "FiT-XL/2 B16 T256 H16 d72 RoPE, mixed lengths": fwd_main[dtype],
            "FiT-B/2 B64 T256 H12 d64 RoPE + lse": {
                "ms": b2["fwd_ms"], "plain_ms": b2["fwd_plain_ms"], "bound_ms": b2["fwd_bound_ms"],
                "bound_by": b2["fwd_bound_by"], "fma_bound_ms": b2["fwd_fma_bound_ms"], "library_ms": b2["sdpa_fwd_ms"],
            },
        }

    for shape, r in k1_at(torch.bfloat16).items():
        print(
            f"K1 bf16 (mma.sync) at {shape}: device us {r['ms'] * 1e3:.1f} (before it: {K1_EARLIER_US[shape]}), "
            f"bound {r['bound_ms'] * 1e3:.1f} by {r['bound_by']}, SDPA fwd {r['library_ms'] * 1e3:.1f}; "
            f"{K1_EARLIER_US[shape] / (r['ms'] * 1e3):.2f}x faster, {r['ms'] / r['library_ms']:.2f}x SDPA; {smi}",
            flush=True,
        )
    for shape, r in k1_at(torch.float32).items():
        us, earlier = r["ms"] * 1e3, FP32_K1_EARLIER_US[shape]
        print(
            f"K1 fp32 (3xTF32 mma.sync) at {shape}: device us {us:.1f} (before it, FMA: {earlier}; {earlier / us:.2f}x "
            f"faster), bound {r['bound_ms'] * 1e3:.1f} by {r['bound_by']} (3xTF32 at 165 TFLOP/s; {r['bound_ms'] * 1e3 / us:.1%} "
            f"of it) and {r['fma_bound_ms'] * 1e3:.1f} at the FMA rate; plain {r['plain_ms'] * 1e3:.1f} "
            f"({r['plain_ms'] * 1e3 / us:.2f}x faster); SDPA fp32 fwd {r['library_ms'] * 1e3:.1f} "
            f"({r['ms'] / r['library_ms']:.2f}x SDPA's time); {smi}",
            flush=True,
        )

    # 8. the command line: a reference checkpoint sampled, quantized and served
    torch.cuda.empty_cache()
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    CLI_DIR.mkdir(parents=True)
    try:
        cli_totals = cli_phase(kernel_modules, smi, step_ms)

        # 9. pixels: the SD-VAE decodes phases 4 and 7's latents and encodes
        # images for the Trainer; the Trainer's ffn="mlp" and learn_sigma loss
        torch.cuda.empty_cache()
        pixel_launches = pixels_phase(kernel_modules, smi, latents, mixed, dit_latents)

        # 10. eval: phase 8's checkpoint sampled to PNGs and scored by cli.fid,
        # Inception on the card vs the CPU, MFU, the native packer
        torch.cuda.empty_cache()
        eval_launches = eval_phase(kernel_modules, smi, step_ms, train_step_s)
    finally:
        shutil.rmtree(CLI_DIR, ignore_errors=True)

    def strided_entry(name, replaces, main_case):
        main = strided[(main_case, torch.bfloat16)]
        err = max(r["max_abs_err"] for (i, _), r in strided.items() if STRIDED_CASES[i][0] == name)
        return entry(name, "fit_tpu_torch/ops/csrc/rope_attention.cu", replaces, err, main["ms"], main["plain_ms"],
                     main["bound_ms"], main["bound_by"], main["library_ms"])

    def entry(name, source, replaces, err, ms, plain_ms, bound, bound_by, library_ms=None):
        by_path = {"sample": sample_launches[name], "serve": serve_launches[name], "train": train_launches[name],
                   "dit": dit_launches[name], "ditmoe": ditmoe_launches[name], "cli": cli_totals[name],
                   "pixels": pixel_launches[name], "eval": eval_launches[name]}
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": bound_by,
            "library_ms": library_ms,
        }

    def fp32_numbers(r, err):
        """The fp32 kernel's numbers at an entry's main shape (the bound on
        the 3xTF32 basis, the FMA rate's beside it)."""
        return {"ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "fma_bound_ms": r["fma_bound_ms"], "library_ms": r["library_ms"], "max_abs_err": err}

    row_src = "fit_tpu_torch/ops/csrc/row_quant.cu"
    kernels = [
        {**entry("rope_attention_fwd", "fit_tpu_torch/ops/csrc/rope_attention.cu",
                 "fit_tpu/ops/fused_attention.py:806", max(errs), fwd_main[torch.bfloat16]["ms"],
                 fwd_main[torch.bfloat16]["plain_ms"], fwd_main[torch.bfloat16]["bound_ms"],
                 fwd_main[torch.bfloat16]["bound_by"], fwd_main[torch.bfloat16]["library_ms"]),
         "fp32": fp32_numbers(fwd_main[torch.float32], max(errs[1::2]))},
        {**entry("rope_attention_bwd", "fit_tpu_torch/ops/csrc/rope_attention_bwd.cu",
                 "fit_tpu/ops/fused_attention.py:1173", bwd_main["max_abs_err"], bwd_main["bwd_ms"],
                 bwd_main["bwd_plain_ms"], bwd_main["bwd_bound_ms"], bwd_main["bwd_bound_by"],
                 bwd_main["sdpa_bwd_ms"]),
         "passes_ms": {n: bwd_main[f"bwd_{n}_ms"] for n in K2_PASSES},
         "fp32": {"ms": bwd32["bwd_ms"], "plain_ms": bwd32["bwd_plain_ms"], "bound_ms": bwd32["bwd_bound_ms"],
                  "bound_by": bwd32["bwd_bound_by"], "fma_bound_ms": bwd32["bwd_fma_bound_ms"],
                  "library_ms": bwd32["sdpa_bwd_ms"], "passes_ms": {n: bwd32[f"bwd_{n}_ms"] for n in K2_PASSES},
                  "max_abs_err": max(r["max_abs_err"] for (_, dt), r in grads.items() if dt == torch.float32),
                  "launches": fp32_train_k2}},
        entry("adaln_quant", row_src, "fit_tpu/ops/quant.py:184", *rows["adaln_quant"]),
        entry("silu_mul_quant", row_src, "fit_tpu/ops/quant.py:148", *rows["silu_mul_quant"]),
        entry("adaln_modulate", row_src, "fit_tpu/ops/fused_adaln.py:29", *rows["adaln_modulate"]),
        entry("adaln_residual", row_src, "none: K5 with the block's attention residual folded in",
              *rows["adaln_residual"]),
        {**entry("swiglu_glue", row_src, "fit_tpu/ops/fused_adaln.py:66", *rows["swiglu_glue"]),
         "halves": dict(zip(("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by"), moe_cases["swiglu_halves"]),
                        shape=f"{MOE_TOKENS * MOE_TOP_K} x {MOE_HIDDEN}")},
        {**entry("moe_combine", row_src, "none: the sparse-MoE combine (DiT-MoE)", *moe_cases["moe_combine"]),
         "shape": f"{MOE_TOKENS} x {MOE_DIM}, k {MOE_TOP_K}, with shared"},
        {**strided_entry("masked_attention", "fit_tpu/ops/attention.py:90", 0),
         "fp32": fp32_numbers(strided[(0, torch.float32)], max(
             r["max_abs_err"] for (i, dt), r in strided.items() if dt == torch.float32 and STRIDED_CASES[i][0] == "masked_attention"))},
        strided_entry("rope_flash_attention", "fit_tpu/ops/fused_attention.py:375 and :266", 3),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
