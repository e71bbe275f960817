"""The fp32 K2 of this tree against another tree's, on one card, in turns.

    python -m fit_tpu_torch.cli.k2_fp32_ab --baseline DIR [--iters 10]

DIR is the root of another checkout of the repository, for example a
``git archive`` of the parent commit unpacked under ``build/``. Its
``fit_tpu_torch/ops/csrc/rope_attention_bwd.cu`` is built beside this
tree's (the two must share the C interface; this tree's wrapper allocates
the scratch, which covers what the FMA kernel of earlier trees reads), and
K2 runs in fp32 through this tree's wrapper on the same inputs (K1's out
and lse from this tree) at the four shapes of ``chip_smoke.py`` phase 6a
that PERF.md's table reports (``SHAPES``): the FiT-B/2 training
micro-batch, and XL at T 256, 2304 and 4096. The libraries take turns (baseline, this
tree, this tree, baseline), each turn the device time of ``--iters`` calls
queued behind a spin kernel, and each is held against the plain version
(dq, dk and dv within 1e-4 x max(1, max |plain|)). Beside them: this
tree's passes alone (prologue, dk/dv, dq), the plain version's and SDPA's
fp32 backward (on pre-rotated q and k, the boolean key mask; timed, used
nowhere in the port) and the bound on two bases, the 165 TFLOP/s of
fp32-accurate tensor-core products (three TF32 products at 495) and the 67
TFLOP/s of fp32 FMA.

Then one fp32 FiT-B/2 optimizer step (global batch 128 in 2 micro-batches,
remat, TF32 off for the GEMMs) is profiled once per tree by
``profile_train``'s ``profile_step``, with only K2 taken from the baseline:
device ms by group and K2's by kernel. Prints the card's name and power
limit, a line per shape and profile, and last one JSON object.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from functools import partial
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from fit_tpu_torch.cli.k1_fp32_ab import FP32_FMA_FLOPS, FP32_TC_FLOPS, HBM_BYTES_PER_S
from fit_tpu_torch.cli.profile_train import profile_step
from fit_tpu_torch.cli.row_kernels_ab import device_ms
from fit_tpu_torch.core.pos_embed import rope_freqs_2d
from fit_tpu_torch.ops import _build
from fit_tpu_torch.ops import rope_attention as ra

GRAD_REL = 1e-4
# name: (H, d, B, T, lengths), chip_smoke.py's GRAD_SHAPES cases 0, 3, 5 and 6
SHAPES = {
    "FiT-B/2 B64 T256 H12 d64": (12, 64, 64, 256, [256, 200, 130, 64, 1, 255, 129, 33] * 8),
    "XL B16 T256 H16 d72": (16, 72, 16, 256, [256, 256, 200, 130, 64, 1, 255, 129] * 2),
    "XL B2 T2304 H16 d72": (16, 72, 2, 2304, [2304, 1500]),
    "XL B1 T4096 H16 d72": (16, 72, 1, 4096, [4000]),
}
PASSES = {"prologue": 1, "dkdv": 2, "dq": 4}


def bounds_ms(h: int, d: int, b: int, t: int, lengths) -> dict:
    """The least time of one fp32 K2 call: qkv, g, out, lse, the RoPE tables
    and the lengths read once, dqkv written once, and the 5 products of 2 *
    T * len * d per head and batch row over the valid keys, on each basis."""
    act = b * t * h * d * 4
    nbytes = 3 * act + act + act + b * t * h * 4 + 2 * b * t * d * 4 + 4 * b + 3 * act
    flops = 5 * sum(2 * t * n * d * h for n in lengths)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    out = {"bytes": nbytes, "flops": flops}
    for basis, rate in (("tf32x3", FP32_TC_FLOPS), ("fma", FP32_FMA_FLOPS)):
        t_ops = flops / rate * 1e3
        out[basis] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    return out


def k2_case(name: str, seed: int) -> dict:
    """Seeded fp32 inputs of one shape on the card (K1's out and lse), and
    closures that call K2, its plain version and SDPA's backward."""
    h, d, b, t, lengths = SHAPES[name]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, t, 3 * h * d), generator=gen, device="cuda")
    g = torch.randn((b, t, h * d), generator=gen, device="cuda")
    side = int(np.ceil(t**0.5))
    fc = torch.from_numpy(rope_freqs_2d(d, side, side)[:t]).float().cuda()
    cos, sin = (x.expand(b, t, d).contiguous() for x in ra.split_rope_tables(fc))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    out, lse = ra.rope_attention_fwd(qkv, cos, sin, lens, d**-0.5, h, with_lse=True)
    args = (qkv, g, out, lse, cos, sin, lens, d**-0.5, h)
    mask = (torch.arange(t, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    qr, kr, v = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in ra._rotated_heads(qkv, cos, sin, h))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(qr, kr, v, attn_mask=mask, scale=d**-0.5)
    sdpa_g = torch.randn_like(sdpa_out)
    dqkv = torch.empty_like(qkv)
    scratch = ra._k2_scratch(qkv, h)
    return {
        "call": partial(ra.rope_attention_bwd, *args),
        "plain": partial(ra.rope_attention_backward_reference, *args),
        "library": lambda: torch.autograd.grad(sdpa_out, (qr, kr, v), sdpa_g, retain_graph=True),
        "pass": lambda bit: ra._k2_launch(*args, dqkv, *scratch, passes=bit),
        "width": h * d,
        "bounds": bounds_ms(h, d, b, t, lengths),
    }


def checked(case: dict, want: torch.Tensor, which: str, name: str) -> float:
    got = case["call"]()
    torch.cuda.synchronize()
    c = case["width"]
    errs = [(got[..., i * c:(i + 1) * c] - want[..., i * c:(i + 1) * c]).abs().max().item()
            / max(1.0, want[..., i * c:(i + 1) * c].abs().max().item()) for i in range(3)]
    if not (max(errs) <= GRAD_REL and torch.isfinite(got).all()):
        raise AssertionError(f"{which} fp32 K2 at {name}: dq, dk, dv rel errors {errs} > {GRAD_REL}")
    return max(errs)


def bwd_lib(baseline_csrc: Path):
    """``ra._lib`` with rope_attention_bwd built from ``baseline_csrc`` and
    every other source from this tree."""
    this_lib = ra._lib

    def lib(source, src_dir=_build.CSRC):
        return this_lib(source, baseline_csrc if source == "rope_attention_bwd" else src_dir)

    return lib


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", required=True, help="root of the other checkout")
    parser.add_argument("--iters", type=int, default=10)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2_fp32_ab: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libs = {"baseline": bwd_lib(Path(args.baseline) / "fit_tpu_torch/ops/csrc"), "this": ra._lib}
    for lib in libs.values():
        lib("rope_attention")
        lib("rope_attention_bwd")  # build both before any timing
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(f"device: {smi}", flush=True)
    order = ("baseline", "this", "this", "baseline")
    results = []
    for i, name in enumerate(SHAPES):
        case = k2_case(name, seed=100 + i)
        want = case["plain"]().float()
        turns, errs = {k: [] for k in libs}, {}
        for which in order:
            with mock.patch.object(ra, "_lib", libs[which]):
                errs[which] = checked(case, want, which, name)
                turns[which].append(device_ms(case["call"], max(2, args.iters // 5) if which == "baseline" else args.iters) * 1e3)
        mean = {k: sum(v) / len(v) for k, v in turns.items()}
        case["pass"](7)  # a whole call fills the scratch that each pass alone reads
        passes_us = {n: device_ms(partial(case["pass"], bit), args.iters) * 1e3 for n, bit in PASSES.items()}
        plain_us = device_ms(case["plain"], 2) * 1e3
        sdpa_us = device_ms(case["library"], args.iters) * 1e3
        bnd = case["bounds"]
        res = {"shape": name, "us": turns, "mean_us": mean, "passes_us": passes_us, "plain_us": plain_us,
               "sdpa_bwd_us": sdpa_us, "bound_us": bnd["tf32x3"][0] * 1e3, "bound_by": bnd["tf32x3"][1],
               "fma_bound_us": bnd["fma"][0] * 1e3, "fma_bound_by": bnd["fma"][1],
               "gflop": bnd["flops"] / 1e9, "mbytes": bnd["bytes"] / 1e6, "max_rel_err": errs}
        results.append(res)
        print(
            f"fp32 K2 at {name}: baseline us {turns['baseline']} mean {mean['baseline']:.1f} "
            f"({mean['baseline'] / mean['this']:.2f}x this tree's time); this tree us {turns['this']} mean "
            f"{mean['this']:.1f} ({res['gflop'] / mean['this'] * 1e3:.1f} TFLOP/s over the 5 products); passes alone "
            + ", ".join(f"{n} {us:.1f}" for n, us in passes_us.items())
            + f"; bound {res['bound_us']:.1f} us by {res['bound_by']} (3xTF32 at 165 TFLOP/s; FMA at 67: "
            f"{res['fma_bound_us']:.1f} by {res['fma_bound_by']}); plain {plain_us:.1f} "
            f"({plain_us / mean['this']:.2f}x), SDPA fp32 bwd {sdpa_us:.1f} ({mean['this'] / sdpa_us:.2f}x SDPA's "
            f"time); max rel err {errs}; {res['gflop']:.2f} GFLOP, {res['mbytes']:.1f} MB; {smi}",
            flush=True,
        )
    profiles = {}
    for which in libs:
        with mock.patch.object(ra, "_lib", libs[which]):
            profiles[which] = prof = profile_step(dtype=torch.float32)
        print(
            f"fp32 FiT-B/2 optimizer step (128 = 2 x 64, T 256, remat), {which} tree: step {prof['step_ms']:.2f} ms, "
            f"device {prof['device_ms_per_step']:.2f} ms; "
            + ", ".join(f"{g} {v:.3f} ms" for g, v in prof["device_ms_by_group"].items())
            + f"; K2 by kernel {prof['k2_ms_by_pass']}; {smi}",
            flush=True,
        )
    out = {"device": smi, "iters": args.iters, "results": results, "profiles": profiles}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
