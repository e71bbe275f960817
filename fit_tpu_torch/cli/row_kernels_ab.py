"""The row kernels of this tree against another tree's, on one card, in turns.

    python -m fit_tpu_torch.cli.row_kernels_ab --baseline DIR [--iters 50]

DIR is the root of another checkout of the repository, for example a
``git archive`` of the parent commit unpacked under ``build/``. Its
``fit_tpu_torch/ops/csrc/row_quant.cu`` is built beside this tree's (the two
must share the C interface; an entry the baseline lacks runs on this tree
alone), and each row kernel runs through this tree's wrappers on the same
bf16 inputs at the FiT-XL/2 shapes: K3 ``adaln_quant``, K5
``adaln_modulate`` and K5R ``adaln_residual`` at width 1152, K4
``silu_mul_quant`` and K6 ``swiglu_glue`` at 3072, over 4,096, 16,384 (the
serving cell's batch), 1,255 and 51,200 rows (the sampling cell's). The two
libraries take turns (baseline, this tree, this tree, baseline), each turn
the device time of ``--iters`` launches queued behind a spin kernel, and
both are held against the plain version: int8 codes within one step on at
most 1e-3 of them, scales within 1e-6 relative, one bf16 ulp without the
int8 epilogue, K5R's residual bit for bit. Prints the card's name and power
limit, one line per kernel and shape (each turn's µs, the bound and each
tree's share of it) and, last, one JSON object.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path
from unittest import mock

import torch

from fit_tpu_torch.ops import _build, fused_adaln, quant

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
XL_HIDDEN, XL_MLP = 1152, 3072
# batch 8 and 32 with CFG (the serving cell's), a ragged row count, batch 100 with CFG (the sampling cell's)
ROW_SHAPES = [(16, 256), (64, 256), (5, 251), (200, 256)]
# name: (width, int8 epilogue, wrapper, C entry)
VARIANTS = {
    "adaln_quant": (XL_HIDDEN, True, quant.adaln_quant, "adaln_rows_fwd"),
    "adaln_modulate": (XL_HIDDEN, False, fused_adaln.adaln_modulate, "adaln_rows_fwd"),
    "adaln_residual": (XL_HIDDEN, False, fused_adaln.adaln_residual, "adaln_resid_rows_fwd"),
    "silu_mul_quant": (XL_MLP, True, quant.silu_mul_quant, "silu_mul_rows_fwd"),
    "swiglu_glue": (XL_MLP, False, fused_adaln.swiglu_glue, "silu_mul_rows_fwd"),
}


def row_inputs(name: str, b: int, t: int) -> tuple:
    """Seeded bf16 inputs of one row kernel on the card: x (B, T, width)
    and, for adaLN, shift and scale as chunks of a (B, 6 * width) adaLN
    output, with K5R's y (B, T, width) and gate before them; for the SwiGLU
    glue, gate and value."""
    width = VARIANTS[name][0]
    gen = torch.Generator(device="cuda").manual_seed(b * t)
    x = (torch.randn((b, t, width), generator=gen, device="cuda") * 3 + 1).to(torch.bfloat16)
    if name == "adaln_residual":
        y = torch.randn((b, t, width), generator=gen, device="cuda").to(torch.bfloat16)
        mod = torch.randn((b, 6 * width), generator=gen, device="cuda").to(torch.bfloat16)
        _, _, gate, shift, scale, _ = mod.chunk(6, dim=-1)
        return x, y, gate, shift, scale
    if name.startswith("adaln"):
        mod = torch.randn((b, 6 * width), generator=gen, device="cuda").to(torch.bfloat16)
        return x, mod[:, :width], mod[:, width : 2 * width]
    return x, torch.randn((b, t, width), generator=gen, device="cuda").to(torch.bfloat16)


def row_bytes(name: str, b: int, t: int) -> int:
    """The least traffic of one call: each bf16 input read once (shift,
    scale and gate once per batch row), each output written once (int8
    codes and an fp32 scale per row, or bf16; K5R writes x_new and h). The
    arithmetic is far below the ridge."""
    width, with_quant = VARIANTS[name][:2]
    rows = b * t
    if name == "adaln_residual":
        return rows * width * 2 * 4 + 3 * b * width * 2
    reads = rows * width * 2 * (1 if name.startswith("adaln") else 2)
    reads += 2 * b * width * 2 if name.startswith("adaln") else 0
    writes = rows * width + rows * 4 if with_quant else rows * width * 2
    return reads + writes


def bf16_ulps(got, want) -> float:
    """Largest |got - want| in bf16 ulps of want, a value under 2^-8 in
    magnitude judged at the ulp of 2^-8: where shift + n * (1 + scale)
    cancels to near zero, fp32 sums taken in another order differ by ~1e-7,
    which is many ulps of the tiny result but no error of the kernel."""
    want = want.float()
    exp = torch.floor(torch.log2(want.abs().clamp_min(2.0**-8)))
    return ((got.float() - want).abs() / torch.exp2(exp - 7)).max().item()


def check(name: str, got, want) -> "tuple[bool, float, str]":
    """(within the bars, max abs error, what was compared) of a row kernel's
    output against its plain version's."""
    if name == "adaln_residual":
        (x_new, h), (x_ref, h_ref) = got, want
        same = torch.equal(x_new, x_ref)
        ulps = bf16_ulps(h, h_ref)
        err = (h.float() - h_ref.float()).abs().max().item()
        return same and ulps <= 1, err, f"x_new bit-equal={same} max_ulps={ulps:.3f}"
    if VARIANTS[name][1]:
        (q, s), (q_ref, s_ref) = got, want
        dq = (q.int() - q_ref.int()).abs()
        n_diff = int((dq > 0).sum().item())
        s_rel = ((s - s_ref).abs() / s_ref).max().item()
        err = (q.float() * s - q_ref.float() * s_ref).abs().max().item()
        detail = f"max|dq|={int(dq.max().item())} codes differing={n_diff}/{dq.numel()} scale_rel={s_rel:.2e}"
        return dq.max().item() <= 1 and n_diff <= 1e-3 * dq.numel() and s_rel <= 1e-6, err, detail
    ulps = bf16_ulps(got, want)
    return ulps <= 1, (got.float() - want.float()).abs().max().item(), f"max_ulps={ulps:.3f}"


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


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", required=True, help="root of the other checkout")
    parser.add_argument("--iters", type=int, default=50)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("row_kernels_ab: needs a CUDA card")
    libs = {
        "baseline": fused_adaln.bind(_build.load("row_quant", Path(args.baseline) / "fit_tpu_torch/ops/csrc")),
        "this": fused_adaln._lib(),
    }
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(f"device: {smi}", flush=True)
    results = []
    for name, (width, _, fn, c_entry) in VARIANTS.items():
        # a kernel the baseline's library lacks is timed on this tree alone
        order = ("baseline", "this", "this", "baseline") if hasattr(libs["baseline"], c_entry) else ("this", "this")
        for b, t in ROW_SHAPES:
            args_ = row_inputs(name, b, t)
            want = fn(*args_, plain=True)
            turns, checked = {which: [] for which in order}, {}
            for which in order:
                with mock.patch.object(fused_adaln, "_lib", lambda: libs[which]):
                    ok, err, detail = checked[which] = check(name, fn(*args_), want)
                    if not ok:
                        raise AssertionError(f"{which} {name} at {(b, t, width)} disagrees with the plain version: {detail}")
                    turns[which].append(device_ms(lambda: fn(*args_), args.iters) * 1e3)
            bound_us = row_bytes(name, b, t) / HBM_BYTES_PER_S * 1e6
            mean = {k: sum(v) / len(v) for k, v in turns.items()}
            results.append({"kernel": name, "rows": b * t, "width": width, "us": turns, "mean_us": mean,
                            "bound_us": bound_us, "max_abs_err": {k: v[1] for k, v in checked.items()}})
            base = (f"baseline us {turns['baseline']} mean {mean['baseline']:.2f} "
                    f"({bound_us / mean['baseline']:.0%} of bound); " if "baseline" in turns else "no baseline; ")
            print(
                f"{name} rows={b * t} width={width} bf16: {base}this tree us {turns['this']} "
                f"mean {mean['this']:.2f} ({bound_us / mean['this']:.0%} of bound); bound {bound_us:.2f} us by "
                f"bytes; " + (f"{mean['baseline'] / mean['this']:.2f}x; " if "baseline" in turns else "")
                + f"this tree vs plain {checked['this'][2]}",
                flush=True,
            )
    out = {"device": smi, "iters": args.iters, "results": results}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
