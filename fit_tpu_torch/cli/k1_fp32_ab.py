"""The fp32 K1 of this tree against another tree's, on one card, in turns.

    python -m fit_tpu_torch.cli.k1_fp32_ab --baseline DIR [--iters 10]

DIR is the root of another checkout of the repository, for example a
``git archive`` of the parent commit unpacked under ``build/``. Its
``fit_tpu_torch/ops/csrc/rope_attention.cu`` is built beside this tree's
(the two must share the C interface), and K1 runs in fp32 through this
tree's wrappers on the same inputs at its three main-path shapes
(``SHAPES``): DiT-XL/2 at 512^2 through ``masked_attention`` on (B, H, T,
d) views (RoPE off), FiT-XL/2 sampling through ``qkv_rope_attention`` with
mixed lengths, FiT-B/2 training through ``rope_attention_fwd`` with the lse
output. The libraries take turns (baseline, this tree, this tree,
baseline), each turn the device time of ``--iters`` launches queued behind
a spin kernel, and each is held against the plain version (1e-4 max abs
on the valid rows, the lse within 1e-4 x max(1, max |lse|)). Beside them:
the plain version's and SDPA's fp32 forward (on pre-rotated q and k, the
boolean key mask; timed, used nowhere in the port) and the bound on two
bases, the 165 TFLOP/s of fp32-accurate tensor-core products (three TF32
products at 495) and the 67 TFLOP/s of fp32 FMA.

Then one guided fp32 FiT-XL/2 forward (seeded random weights, 16 rows x T
256, TF32 off for the GEMMs) runs under ``torch.profiler`` once per tree:
device ms of K1, the GEMMs and the rest.
Prints the card's name and power limit, a line per shape and profile, and
last one JSON object.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from functools import partial
from pathlib import Path
from unittest import mock

import torch

from fit_tpu_torch.cli.profile_train import group_of
from fit_tpu_torch.cli.row_kernels_ab import device_ms
from fit_tpu_torch.core.pos_embed import rope_freqs_2d
from fit_tpu_torch.ops import attention as attn
from fit_tpu_torch.ops import rope_attention as ra

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA's data sheet)
FP32_TC_FLOPS = 495e12 / 3  # dense TF32 tensor cores, three products for each fp32-accurate one
FP32_FMA_FLOPS = 67e12  # fp32 outside the tensor cores
FP32_ATOL = 1e-4
PADDED16 = [256, 256, 200, 130, 64, 1, 255, 129, 256, 256, 224, 180, 256, 33, 2, 256]
B2_LENGTHS = [256, 200, 130, 64, 1, 255, 129, 33] * 8
# name: (entry, H, d, T, lengths)
SHAPES = {
    "DiT-XL/2 512^2 B16 T1024 H16 d72 RoPE off": ("masked_attention", 16, 72, 1024, [1024] * 16),
    "FiT-XL/2 B16 T256 H16 d72 RoPE, mixed lengths": ("qkv_rope_attention", 16, 72, 256, PADDED16),
    "FiT-B/2 B64 T256 H12 d64 RoPE + lse": ("rope_attention_fwd", 12, 64, 256, B2_LENGTHS),
}


def bounds_ms(h: int, d: int, t: int, lengths, rope: bool, with_lse: bool) -> dict:
    """The least time of one fp32 call: each input read once (qkv, the RoPE
    tables, the lengths), each output written once (out, the lse), and two
    products of 2 * T * len * d per head and batch row over the valid keys,
    on each basis."""
    b = len(lengths)
    nbytes = 4 * (3 * b * t * h * d + b * t * h * d + b) + (8 * b * t * d if rope else 0)
    nbytes += 4 * b * t * h if with_lse else 0
    flops = 2 * sum(2 * t * n * d * h for n in lengths)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    out = {"bytes": nbytes, "flops": flops}
    for basis, rate in (("tf32x3", FP32_TC_FLOPS), ("fma", FP32_FMA_FLOPS)):
        t_ops = flops / rate * 1e3
        out[basis] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    return out


def k1_case(name: str, seed: int = 0) -> dict:
    """Seeded fp32 inputs of one shape on the card, and closures that call
    its K1 entry, the plain version and SDPA. ``check(got)`` returns the max
    abs error on valid rows (and of the lse)."""
    entry, h, d, t, lengths = SHAPES[name]
    b = len(lengths)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, t, 3 * h * d), generator=gen, device="cuda")
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    mask = (torch.arange(t, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    scale = d**-0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if entry == "masked_attention":
        q, k, v = qkv.view(b, t, 3, h, d).transpose(1, 3).unbind(2)  # (B, H, T, d) views
        call = partial(attn.masked_attention, q, k, v, lengths=lens)
        plain = partial(attn.masked_attention_reference, q, k, v, lens, scale)
        library = partial(sdpa, q, k, v, attn_mask=mask, scale=scale)

        def check(got):
            want = plain()
            return max((got[i, :, :n] - want[i, :, :n]).abs().max().item() for i, n in enumerate(lengths)), 0.0

    else:
        side = int(t**0.5)
        fc = torch.from_numpy(rope_freqs_2d(d, side, side)).float().cuda()
        cos, sin = (x.expand(b, t, d).contiguous() for x in ra.split_rope_tables(fc))
        with_lse = entry == "rope_attention_fwd"
        if with_lse:
            call = partial(ra.rope_attention_fwd, qkv, cos, sin, lens, scale, h, with_lse=True, check_lengths=False)
        else:
            call = partial(ra.qkv_rope_attention, qkv, cos, sin, lens, scale, h, check_lengths=False)
        plain = partial(ra.rope_attention_reference, qkv, cos, sin, lens, scale, h, with_lse=with_lse)
        qr, kr, vh = (x.transpose(1, 2).contiguous() for x in ra._rotated_heads(qkv, cos, sin, h))
        library = partial(sdpa, qr, kr, vh, attn_mask=mask, scale=scale)

        def check(got):
            (out, lse), (want, lse_want) = (got, plain()) if with_lse else ((got, None), (plain(), None))
            err = max((out[i, :n] - want[i, :n]).abs().max().item() for i, n in enumerate(lengths))
            if not with_lse:
                return err, 0.0
            lse_err = (lse - lse_want).abs().max().item() / max(1.0, lse_want.abs().max().item())
            return err, lse_err

    return {"call": call, "plain": plain, "library": library, "check": check,
            "bounds": bounds_ms(h, d, t, lengths, entry != "masked_attention", entry == "rope_attention_fwd")}


def checked(case: dict, which: str, name: str) -> "tuple[float, float]":
    got = case["call"]()
    torch.cuda.synchronize()
    err, lse_err = case["check"](got)
    if not (err <= FP32_ATOL and lse_err <= FP32_ATOL):
        raise AssertionError(f"{which} fp32 K1 at {name}: max abs err {err:.3e}, lse rel {lse_err:.3e} > {FP32_ATOL}")
    return err, lse_err


def fp32_forward_profile(seed: int = 0) -> dict:
    """One guided fp32 FiT-XL/2 forward (seeded N(0, 0.02) weights, 8
    images of 256^2 with CFG: 16 rows x T 256) under torch.profiler, after a
    warm-up. Returns the device ms by group and K1's launches in the window."""
    from fit_tpu_torch.models.fit import create_fit
    from fit_tpu_torch.sampling import create_pos_embed

    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = create_fit("FiT-XL/2", dtype=torch.float32, device="cuda")
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=gen)
    n = 8
    tab, valid_t = create_pos_embed(32, 32, 2, 256, model.head_dim)
    pos = torch.from_numpy(tab[0]).float().cuda().expand(2 * n, -1, -1).contiguous()
    mask = (torch.arange(256, device="cuda") < valid_t).expand(2 * n, -1).contiguous()
    x = torch.randn((n, 4, 32, 32), generator=gen, device="cuda")
    inputs = (torch.cat([x, x]), torch.full((2 * n,), 500, device="cuda"),
              torch.cat([torch.arange(n, device="cuda"), torch.full((n,), 1000, device="cuda")]), pos, mask)

    def forward():
        with torch.inference_mode():
            return model.forward_with_cfg(*inputs, 1.5)

    forward()
    torch.cuda.synchronize()
    ra.reset_launches()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = forward()
        torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError("non-finite fp32 guided forward")
    by_group = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            group = group_of(evt.name)
            by_group[group] = by_group.get(group, 0.0) + evt.time_range.elapsed_us() / 1e3
    return {"device_ms": sum(by_group.values()), "by_group_ms": by_group, "k1_launches": ra.launches}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", required=True, help="root of the other checkout")
    parser.add_argument("--iters", type=int, default=10)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_fp32_ab: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libs = {"baseline": partial(ra._lib, src_dir=Path(args.baseline) / "fit_tpu_torch/ops/csrc"), "this": ra._lib}
    for lib in libs.values():
        lib("rope_attention")  # build both before any timing
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(f"device: {smi}", flush=True)
    order = ("baseline", "this", "this", "baseline")
    results = []
    for i, name in enumerate(SHAPES):
        case = k1_case(name, seed=i)
        turns, errs = {k: [] for k in libs}, {}
        for which in order:
            with mock.patch.object(ra, "_lib", libs[which]):
                errs[which] = checked(case, which, name)
                turns[which].append(device_ms(case["call"], args.iters) * 1e3)
        mean = {k: sum(v) / len(v) for k, v in turns.items()}
        plain_us = device_ms(case["plain"], 3) * 1e3
        sdpa_us = device_ms(case["library"], args.iters) * 1e3
        bnd = case["bounds"]
        res = {"shape": name, "us": turns, "mean_us": mean, "plain_us": plain_us, "sdpa_us": sdpa_us,
               "bound_us": bnd["tf32x3"][0] * 1e3, "bound_by": bnd["tf32x3"][1],
               "fma_bound_us": bnd["fma"][0] * 1e3, "fma_bound_by": bnd["fma"][1],
               "gflop": bnd["flops"] / 1e9, "mbytes": bnd["bytes"] / 1e6,
               "max_abs_err": {k: v[0] for k, v in errs.items()}, "lse_rel_err": {k: v[1] for k, v in errs.items()}}
        results.append(res)
        print(
            f"fp32 K1 at {name}: baseline us {turns['baseline']} mean {mean['baseline']:.1f} "
            f"({mean['baseline'] / mean['this']:.2f}x this tree's time); this tree us {turns['this']} mean {mean['this']:.1f} "
            f"({res['gflop'] / mean['this'] * 1e3:.1f} TFLOP/s); bound {res['bound_us']:.1f} us by {res['bound_by']} "
            f"(3xTF32 at 165 TFLOP/s; FMA at 67: {res['fma_bound_us']:.1f} by {res['fma_bound_by']}); plain "
            f"{plain_us:.1f} ({plain_us / mean['this']:.2f}x), SDPA fp32 fwd {sdpa_us:.1f} "
            f"({mean['this'] / sdpa_us:.2f}x SDPA's time); max abs err {res['max_abs_err']}, lse "
            f"{res['lse_rel_err']}; {res['gflop']:.2f} GFLOP, {res['mbytes']:.1f} MB",
            flush=True,
        )
    profiles = {}
    for which in libs:
        with mock.patch.object(ra, "_lib", libs[which]):
            profiles[which] = prof = fp32_forward_profile()
        print(
            f"fp32 guided FiT-XL/2 forward, 16 rows x T 256, {which} tree: device {prof['device_ms']:.2f} ms; "
            + ", ".join(f"{g} {v:.3f} ms" for g, v in sorted(prof["by_group_ms"].items(), key=lambda kv: -kv[1]))
            + f"; K1 launches {prof['k1_launches']}; {smi}",
            flush=True,
        )
    out = {"device": smi, "iters": args.iters, "results": results, "profiles": profiles}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
