#!/usr/bin/env python3
"""Smoke run of the PyTorch port (fit_tpu_torch) on one CUDA card.

Run from the root of the repository, on a machine with an NVIDIA Hopper
card and the CUDA toolkit:

    python3 chip_smoke.py

Phases, each printing one line; any failure raises (non-zero exit):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compiles the CUDA kernels from the sources in the checkout;
  3. kernel vs plain: the RoPE + masked attention kernel against its plain
     PyTorch version at the shapes of the main path, with the time of both;
  4. slice: FiT-XL/2 with seeded random weights, 256x256 DDIM + CFG
     ``FiTSampler.sample`` at batch 8 and ``sample_mixed`` over four aspect
     ratios, checking the outputs, the kernel's launch count and one guided
     forward against the same forward with the plain attention.
The line before the last is a JSON object with each kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device it
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

STEPS = 10
CFG_SCALE = 1.5
BATCH = 8
MIXED_SIZES = [(256, 256), (224, 288), (192, 320), (256, 224)]
DEPTH = 28  # FiT-XL/2 blocks, one kernel launch each per denoise step
BF16_ATOL = 3e-2  # bf16 q/k, p and output roundings against the fp32 plain version
FP32_ATOL = 1e-4  # fp32 FMA dots, another summation order
FORWARD_REL_RMS = 5e-2  # a full bf16 XL forward, kernel vs plain attention


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


def attention_case(ra, rope_freqs_2d, h, d, t, lengths, dtype, seed):
    """Kernel vs plain on one shape: (max abs err on valid rows, kernel ms, plain ms)."""
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
    return err, ms, plain_ms


def guided_forward_rel_rms(model, sampler_mod, head_dim, sizes, gen):
    """Relative RMS between one guided forward through the kernel and the
    same forward through the plain attention, at the given image sizes."""
    n = len(sizes)
    pos = torch.zeros((n, 256, head_dim))
    mask = torch.zeros((n, 256), dtype=torch.bool)
    for i, (ih, iw) in enumerate(sizes):
        tab, valid_t = sampler_mod.create_pos_embed(ih // 8, iw // 8, 2, 256, head_dim)
        pos[i] = torch.from_numpy(tab[0])
        mask[i, :valid_t] = True
    pos2, mask2 = torch.cat([pos, pos]).cuda(), torch.cat([mask, mask]).cuda()
    x = torch.randn((2 * n, 4, 32, 32), generator=gen, device="cuda")
    t = torch.full((2 * n,), 500, device="cuda")
    y = torch.cat([torch.arange(n, device="cuda"), torch.full((n,), 1000, device="cuda")])
    with torch.inference_mode():
        out_kernel = model.forward_with_cfg(x, t, y, pos2, mask2, CFG_SCALE)
        model.plain_attention = True
        try:
            out_plain = model.forward_with_cfg(x, t, y, pos2, mask2, CFG_SCALE)
        finally:
            model.plain_attention = False
    if not (torch.isfinite(out_kernel).all() and torch.isfinite(out_plain).all()):
        raise AssertionError("non-finite guided forward")
    return ((out_kernel - out_plain).pow(2).mean() / out_plain.pow(2).mean()).sqrt().item()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this check needs a CUDA card")
    from fit_tpu_torch import sampling as sampler_mod
    from fit_tpu_torch.core.pos_embed import rope_freqs_2d
    from fit_tpu_torch.models.fit import create_fit
    from fit_tpu_torch.ops import _build
    from fit_tpu_torch.ops import rope_attention as ra

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    ra._kernel()
    build_s = time.perf_counter() - t0
    ptxas = sorted({
        line.split("ptxas info    : ")[1]
        for log in _build.BUILD_DIR.glob("rope_attention_*.log")
        for line in log.read_text().splitlines()
        if "Used" in line and "registers" in line
    })
    print(f"build: rope_attention.cu in {build_s:.2f} s; ptxas: {ptxas}", flush=True)

    # 3. kernel vs plain, at the main path's shapes (XL: H=16, d=72; L: d=64)
    padded16 = [256, 256, 200, 130, 64, 1, 255, 129, 256, 256, 224, 180, 256, 33, 2, 256]
    errs = []
    main_ms = main_plain_ms = None
    for h, d, t, lengths in [
        (16, 72, 256, padded16),  # 256^2 sampling, batch 8 with CFG
        (16, 72, 1024, [1024, 700]),  # 512^2 extrapolation
        (16, 64, 256, padded16),  # head dim of FiT-S/B/L
    ]:
        for dtype in (torch.bfloat16, torch.float32):
            err, ms, plain_ms = attention_case(ra, rope_freqs_2d, h, d, t, lengths, dtype, seed=len(errs))
            errs.append(err)
            if main_ms is None:
                main_ms, main_plain_ms = ms, plain_ms

    # 4. the slice: FiT-XL/2, seeded random weights, DDIM + CFG at 256^2
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = create_fit("FiT-XL/2", dtype=torch.bfloat16, device="cuda")
    with torch.no_grad():
        for p in model.parameters():  # reference init zeroes adaLN: its eps would be 0
            p.normal_(0.0, 0.02, generator=gen)
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ra.reset_launches()
    t0 = time.perf_counter()
    latents = sampler.sample(labels, 256, 256, generator=gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mixed = sampler.sample_mixed(labels[:4], MIXED_SIZES, generator=gen)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = ra.launches
    expected = DEPTH * STEPS * 2
    if launches != expected:
        raise AssertionError(f"kernel launched {launches} times on the main path, expected {expected}")
    if tuple(latents.shape) != (BATCH, 4, 32, 32) or not torch.isfinite(latents).all():
        raise AssertionError(f"bad sample output: {tuple(latents.shape)}")
    want_shapes = [(4, ih // 8, iw // 8) for ih, iw in MIXED_SIZES]
    if [tuple(m.shape) for m in mixed] != want_shapes or not all(torch.isfinite(m).all() for m in mixed):
        raise AssertionError(f"bad sample_mixed output: {[tuple(m.shape) for m in mixed]}")
    step_ms = (t1 - t0) / STEPS * 1e3
    print(
        f"slice: FiT-XL/2 256x256 DDIM {STEPS} steps cfg {CFG_SCALE} batch {BATCH}: "
        f"{step_ms:.2f} ms/step, {BATCH / (t1 - t0):.3f} img/s; sample_mixed x4 "
        f"{(t2 - t1) / STEPS * 1e3:.2f} ms/step; kernel launches {launches}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
        flush=True,
    )

    kernels = [{
        "name": "rope_attention_fwd",
        "route": "cuda",
        "source": "fit_tpu_torch/ops/csrc/rope_attention.cu",
        "replaces": "fit_tpu/ops/fused_attention.py:806",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": main_ms,
        "plain_ms": main_plain_ms,
    }]
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
