"""Device time of each hand-written kernel at the shapes of PERF.md's
section 6, beside its plain version, SDPA and its bound.

    python -m fit_tpu_torch.cli.kernel_times [--baseline DIR] [--iters 20]

One line per case (``CASES``: a row of one of section 6's two tables, bf16
or fp32, at one of its shapes): the kernel's device µs a call, the plain
PyTorch version's, SDPA's where the table has it (on pre-rotated q and k
with the boolean key mask, so it leaves RoPE out), and the bound from
``fit_tpu_torch.utils.flops`` with what sets it, bytes or operations (fp32
attention on the 3xTF32 basis, the fp32 FMA rate's after the slash). Each
time is the mean of ``--iters`` calls queued behind a spin kernel, so the
CUDA events around them time the card alone. TF32 is off for the plain
versions and SDPA.

With ``--baseline DIR``, the root of another checkout (for example a ``git
archive`` of the parent commit unpacked under ``build/``), each kernel is
also built from DIR's ``fit_tpu_torch/ops/csrc/`` and run through this
tree's wrappers, the two builds taking turns (baseline, this tree, this
tree, baseline). The two must share the C interface; a kernel whose entry
the baseline lacks runs on this tree alone. Times only: the kernels are
held against their plain versions by the card tests
(``tests/test_torch_port_cuda*.py``).

Prints the card's name and power limit first and one JSON object last.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
from functools import partial
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple
from unittest import mock

import numpy as np
import torch

from fit_tpu_torch.utils.flops import bound_us, cross_work, k1_work, k2_pass_work, k2_work, row_work

PADDED16 = (256, 256, 200, 130, 64, 1, 255, 129, 256, 256, 224, 180, 256, 33, 2, 256)
B2_LENGTHS = (256, 200, 130, 64, 1, 255, 129, 33) * 8  # the FiT-B/2 training micro-batch
XL16 = (256, 256, 200, 130, 64, 1, 255, 129) * 2
PASSES = {"prologue": 1, "dkdv": 2, "dq": 4}  # the bits of rope_attention_bwd's passes


@dataclasses.dataclass(frozen=True)
class Case:
    """One timed call: ``row`` of section 6's ``table`` ("bf16" or "fp32"),
    ``kernel`` a wrapper's name (a K2 pass as "k2_<pass>") and its shape:
    (heads, head dim, T, lengths) for attention, (rows, width, batch) for
    a row kernel (tokens for ``moe_combine``); for ``cross_attention``
    (heads, head dim, query tokens, the rows' key lengths), the keys as many
    as the longest length."""

    table: str
    row: str
    kernel: str
    shape: tuple

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.table == "bf16" else torch.float32

    @property
    def attention(self) -> bool:
        return not self.kernel.startswith(("adaln", "silu", "swiglu", "moe", "qk_norm", "gelu"))

    def work(self) -> Tuple[float, float]:
        """(FLOPs, bytes) of one call."""
        es = self.dtype.itemsize
        if not self.attention:
            rows, width, batch = self.shape
            return row_work(self.kernel, rows, width, batch, es)
        h, d, t, lengths = self.shape
        if self.kernel == "cross_attention":
            return cross_work([t] * len(lengths), lengths, h, d, es)
        if self.kernel.startswith("k2_"):
            return k2_pass_work(lengths, h, d, es)[self.kernel[3:]]
        if self.kernel == "rope_attention_bwd":
            return k2_work(lengths, h, d, es)
        return k1_work(lengths, h, d, es, rope=self.kernel != "masked_attention",
                       with_lse=self.kernel == "rope_attention_fwd")

    def bounds(self, device_kind: Optional[str] = None) -> Dict[str, Tuple[float, str]]:
        """The bound in µs and what sets it: on the bf16 rate, or for fp32
        attention on the 3xTF32 basis ("3xtf32") and the FMA rate
        ("float32")."""
        work = self.work()
        if self.table == "bf16" or not self.attention:
            return {"bfloat16": bound_us(work, "bfloat16", device_kind)}
        return {c: bound_us(work, c, device_kind) for c in ("3xtf32", "float32")}


def _cases(table, rows):
    return [Case(table, row, kernel, shape) for row, kernel, shape in rows]


_K1_XL = (16, 72, 256, PADDED16)
_K1_XL_1024 = (16, 72, 4096, (4096,) * 12)  # FiT-XL/2 at 1024^2: 12 guided rows
_K1_FLUX = (24, 128, 4352, (4352,) * 4)  # FLUX.1-schnell's joint attention, batch 4
_K1_FULL = (16, 72, 256, (256,) * 16)
_K1_B2 = (12, 64, 256, B2_LENGTHS)
_K1_DIT = (16, 72, 1024, (1024,) * 16)
_K2_T4096 = (16, 72, 4096, (4000,))
_WAN_ROWS = (2 * 32760, 5120, 2)  # Wan2.1-T2V-14B's guided pair of 81-frame 832x480 rows, D 5120
CASES = _cases("bf16", [
    ("1", "qkv_rope_attention", _K1_XL),
    ("1", "qkv_rope_attention", _K1_XL_1024),
    ("2", "rope_flash_attention", _K1_FULL),
    ("3", "rope_flash_attention_views", _K1_FULL),
    ("3", "rope_flash_attention_joint", _K1_FLUX),
    ("4", "rope_attention_fwd", _K1_B2),
    ("5", "rope_attention_bwd", (16, 72, 256, XL16)),
    ("6", "rope_attention_bwd", _K1_B2),
    ("7", "rope_attention_bwd", (16, 72, 2304, (2304, 1500))),
    ("8", "k2_dq", _K2_T4096),
    ("8", "rope_attention_bwd", _K2_T4096),
    ("9", "k2_dkdv", _K2_T4096),
    ("9", "k2_prologue", _K2_T4096),
    ("10", "masked_attention", _K1_DIT),
    ("11", "adaln_modulate", (4096, 1152, 16)),
    ("11", "adaln_modulate", (51200, 1152, 200)),
    ("11", "adaln_modulate_mixed", _WAN_ROWS),
    ("12", "swiglu_glue", (4096, 3072, 16)),
    ("12", "swiglu_glue", (51200, 3072, 200)),
    ("12", "swiglu_halves", (32768, 5632, 1)),
    ("13", "silu_mul_quant", (4096, 3072, 16)),
    ("14", "adaln_quant", (4096, 1152, 16)),
    ("15", "adaln_residual", (4096, 1152, 16)),
    ("15", "adaln_residual", (16384, 1152, 64)),
    ("15", "adaln_residual", (51200, 1152, 200)),
    ("15", "adaln_residual_mixed", _WAN_ROWS),
    ("16", "moe_combine", (16384, 1408, 1)),
    ("17", "qk_norm", (16384, 3 * 3072, 4)),
    ("17", "qk_norm", (17408, 2 * 3072, 4)),
    ("18", "gelu_glue", (16384, 12288, 4)),
    ("18", "gelu_glue", (17408, 12288, 4)),
    ("19", "cross_attention", (40, 128, 32760, (512, 512))),  # Wan's video rows over 512 text keys
    ("20", "qk_norm_wide", _WAN_ROWS),
]) + _cases("fp32", [
    ("10", "masked_attention", _K1_DIT),
    ("1", "qkv_rope_attention", _K1_XL),
    ("4", "rope_attention_fwd", _K1_B2),
    ("6", "rope_attention_bwd", _K1_B2),
    *(("6", f"k2_{p}", _K1_B2) for p in PASSES),
    ("5", "rope_attention_bwd", (16, 72, 256, XL16)),
    ("7", "rope_attention_bwd", (16, 72, 2304, (2304, 1500))),
    ("8, 9", "rope_attention_bwd", _K2_T4096),
    *(("8, 9", f"k2_{p}", _K2_T4096) for p in PASSES),
])


def device_ms(fn: Callable, iters: int) -> float:
    """Device ms a call of ``fn()``: the launches of ``iters`` calls queue
    up behind a spin kernel, so the CUDA events around them time the card
    alone, not the host's launches."""
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


def _attention_calls(case: Case, gen: torch.Generator) -> Dict[str, Optional[Callable]]:
    """The kernel's call, its plain version's and SDPA's (None where the
    table has none) on seeded inputs of ``case`` on the card."""
    from fit_tpu_torch.core.pos_embed import rope_freqs_2d
    from fit_tpu_torch.ops import attention as attn
    from fit_tpu_torch.ops import rope_attention as ra

    h, d, t, lengths = case.shape
    b, scale, dtype = len(lengths), d**-0.5, case.dtype
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if case.kernel == "cross_attention":  # q of the video rows, k and v views of the text rows' [k | v]
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        q = torch.randn((b, t, h, d), generator=gen, device="cuda").to(dtype)
        kv = torch.randn((b, max(lengths), 2, h, d), generator=gen, device="cuda").to(dtype)
        k, v = kv.unbind(2)
        return {"kernel": partial(ra.cross_attention, q, k, v, lens, scale),
                "plain": partial(ra.cross_attention_reference, q, k, v, lens, scale),
                "sdpa": partial(sdpa, q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale)}
    qkv = torch.randn((b, t, 3 * h * d), generator=gen, device="cuda").to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    mask = (torch.arange(t, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    if case.kernel == "masked_attention":
        q, k, v = qkv.view(b, t, 3, h, d).transpose(1, 3).unbind(2)  # (B, H, T, d) views
        return {"kernel": partial(attn.masked_attention, q, k, v, lengths=lens),
                "plain": partial(attn.masked_attention_reference, q, k, v, lens, scale),
                "sdpa": partial(sdpa, q, k, v, attn_mask=mask, scale=scale)}
    side = int(np.ceil(t**0.5))
    fc = torch.from_numpy(rope_freqs_2d(d, side, side)[:t]).float().cuda()
    cos, sin = (x.expand(b, t, d).contiguous() for x in ra.split_rope_tables(fc))
    qr, kr, vr = (x.to(dtype).transpose(1, 2).contiguous() for x in ra._rotated_heads(qkv, cos, sin, h))
    if case.kernel.startswith("rope_flash_attention"):
        q, k, v = qkv.view(b, t, 3, h, d).unbind(2)
        if case.kernel.endswith("attention"):
            q, k, v = (x.contiguous() for x in (q, k, v))
        kw = {}
        if case.kernel.endswith("joint"):  # as FLUX's single block: out= into linear2's input [attn | gelu(m)]
            wide = torch.empty((b, t, 5 * h * d), dtype=dtype, device="cuda")
            kw["out"] = wide[..., : h * d].view(b, t, h, d)
        return {"kernel": partial(ra.rope_flash_attention, q, k, v, cos, sin, lens, scale, **kw),
                "plain": partial(ra.rope_flash_reference, q, k, v, cos, sin, lens, scale),
                "sdpa": partial(sdpa, qr, kr, vr, attn_mask=mask, scale=scale)}
    if case.kernel in ("qkv_rope_attention", "rope_attention_fwd"):
        lse = case.kernel == "rope_attention_fwd"
        return {"kernel": partial(ra.rope_attention_fwd, qkv, cos, sin, lens, scale, h, with_lse=lse,
                                  check_lengths=False),
                "plain": partial(ra.rope_attention_reference, qkv, cos, sin, lens, scale, h, with_lse=lse),
                "sdpa": partial(sdpa, qr, kr, vr, attn_mask=mask, scale=scale)}
    g = torch.randn((b, t, h * d), generator=gen, device="cuda").to(dtype)
    out, lse = ra.rope_attention_fwd(qkv, cos, sin, lens, scale, h, with_lse=True)
    args = (qkv, g, out, lse, cos, sin, lens, scale, h)
    if case.kernel.startswith("k2_"):
        dqkv, scratch = torch.empty_like(qkv), ra._k2_scratch(qkv, h)

        def one_pass(bit=PASSES[case.kernel[3:]]):
            ra._k2_launch(*args, dqkv, *scratch, passes=bit)

        def kernel():  # a whole call fills the scratch that a pass alone reads, once
            ra._k2_launch(*args, dqkv, *scratch)
            calls["kernel"] = one_pass

        calls = {"kernel": kernel, "plain": None, "sdpa": None}
        return calls
    qr, kr, vr = (x.requires_grad_(True) for x in (qr, kr, vr))
    sdpa_out = sdpa(qr, kr, vr, attn_mask=mask, scale=scale)
    sdpa_g = torch.randn_like(sdpa_out)
    return {"kernel": partial(ra.rope_attention_bwd, *args),
            "plain": partial(ra.rope_attention_backward_reference, *args),
            "sdpa": lambda: torch.autograd.grad(sdpa_out, (qr, kr, vr), sdpa_g, retain_graph=True)}


def _row_calls(case: Case, gen: torch.Generator) -> Dict[str, Optional[Callable]]:
    """A row kernel's call and its plain version's on seeded inputs: x of
    ``rows`` as (batch, rows / batch, width), shift, scale and gate as
    chunks of a (batch, 6 * width) adaLN output."""
    from fit_tpu_torch.ops import fused_adaln, quant

    rows, width, batch = case.shape
    dtype = case.dtype

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    if case.kernel == "qk_norm_wide":  # Wan's q rows, in place
        args = (randn(batch, rows // batch, width), (1 + 0.1 * randn(width).float()).to(dtype))
        fn = fused_adaln.qk_norm_wide
        return {"kernel": partial(fn, *args), "plain": partial(fn, *args, plain=True), "sdpa": None}
    if case.kernel.endswith("_mixed"):  # Wan's fp32 stream, bf16 rows out (and K5R's bf16 branch in)
        x = torch.randn((batch, rows // batch, width), generator=gen, device="cuda") * 3 + 1
        cond = torch.randn((batch, 9, width), generator=gen, device="cuda") * 0.3
        if case.kernel == "adaln_modulate_mixed":
            fn, args = fused_adaln.adaln_modulate, (x, cond[:, 0], cond[:, 1])
        else:
            fn, args = fused_adaln.adaln_residual, (x, randn(batch, rows // batch, width), *cond[:, 2:5].unbind(1))
        kw = dict(out_dtype=torch.bfloat16)
        return {"kernel": partial(fn, *args, **kw), "plain": partial(fn, *args, plain=True, **kw), "sdpa": None}
    if case.kernel.startswith(("qk_norm", "gelu")):  # FLUX.1-schnell's rows: D 3072, 24 heads of 128
        d, t = 3072, rows // batch
        single = t == 256 + 4096  # a single block's [txt | img] rows, in linear1's output; else a double's image
        scales = (1 + 0.1 * randn(128).float()).to(dtype), (1 + 0.1 * randn(128).float()).to(dtype)
        if case.kernel == "qk_norm" and single:  # q and k in place in linear1's rows
            kw, args, fn = {}, (randn(batch, t, 7 * d), *scales, 24), fused_adaln.qk_norm
        elif case.kernel == "qk_norm":  # the image stream into the joint buffer
            kw = dict(out=torch.empty((batch, t, width), device="cuda", dtype=dtype))
            args, fn = (randn(batch, t, width), *scales, 24), fused_adaln.qk_norm
        elif not single:  # the image stream's MLP
            kw, args, fn = {}, (randn(batch, t, width),), fused_adaln.gelu_glue
        else:  # linear1's m columns into linear2's input after the attention's
            cat = torch.empty((batch, t, d + width), device="cuda", dtype=dtype)
            kw, args, fn = dict(out=cat[..., d:]), (randn(batch, t, 3 * d + width)[..., 3 * d :],), fused_adaln.gelu_glue
        return {"kernel": partial(fn, *args, **kw), "plain": partial(fn, *args, plain=True, **kw), "sdpa": None}
    if case.kernel == "moe_combine":
        k = 2
        args = (randn(rows * k, width), torch.randperm(rows * k, generator=gen, device="cuda").view(rows, k),
                torch.rand((rows, k), generator=gen, device="cuda") * 0.5, randn(rows, width))
        fn = fused_adaln.moe_combine
    elif case.kernel == "swiglu_halves":
        args, fn = (randn(rows, 2 * width),), fused_adaln.swiglu_halves
    else:
        x = (randn(batch, rows // batch, width) * 3 + 1).to(dtype)
        if case.kernel.startswith(("silu", "swiglu")):
            args = (x, randn(batch, rows // batch, width))
        else:
            _, _, gate, shift, scale, _ = randn(batch, 6 * width).chunk(6, dim=-1)
            args = (x, shift, scale)
            if case.kernel == "adaln_residual":
                args = (x, randn(batch, rows // batch, width), gate, shift, scale)
        fn = getattr(quant if case.kernel.endswith("quant") else fused_adaln, case.kernel)
    return {"kernel": partial(fn, *args), "plain": partial(fn, *args, plain=True), "sdpa": None}


def _builds(baseline: Optional[Path]) -> Dict[str, Dict[str, Callable]]:
    """Per tree, the replacements of ``rope_attention._lib`` and
    ``fused_adaln._lib`` that load its build; every library is built
    before any timing. A baseline library that lacks an entry of this
    tree's raises ``AttributeError`` when loaded, and its cases are timed on
    this tree alone."""
    from fit_tpu_torch.ops import _build, fused_adaln
    from fit_tpu_torch.ops import rope_attention as ra

    trees = {"this": _build.CSRC}
    if baseline is not None:
        trees = {"baseline": baseline / "fit_tpu_torch" / "ops" / "csrc", **trees}
    builds = {}
    for which, csrc in trees.items():
        row_lib = fused_adaln.bind(_build.load("row_quant", csrc))
        builds[which] = {"attention": partial(ra._lib, src_dir=csrc), "row": lambda *_, lib=row_lib: lib}
        for source in ("rope_attention", "rope_attention_bwd"):
            _build.load(source, csrc)
    return builds


def time_case(case: Case, builds: Dict[str, Dict[str, Callable]], iters: int, seed: int) -> dict:
    """The kernel's µs on each tree's build in turns, and the plain
    version's and SDPA's µs."""
    from fit_tpu_torch.ops import fused_adaln
    from fit_tpu_torch.ops import rope_attention as ra

    gen = torch.Generator(device="cuda").manual_seed(seed)
    calls = _attention_calls(case, gen) if case.attention else _row_calls(case, gen)
    target, which_lib = (ra, "attention") if case.attention else (fused_adaln, "row")
    turns = {}
    for which in ["baseline", "this", "this", "baseline"] if "baseline" in builds else ["this"]:
        with mock.patch.object(target, "_lib", builds[which][which_lib]):
            try:
                turns.setdefault(which, []).append(device_ms(lambda: calls["kernel"](), iters) * 1e3)
            except AttributeError:  # an entry the baseline's library lacks: this tree alone
                if which != "baseline":
                    raise
                turns.pop(which)
    out = {"us": turns, "mean_us": {k: sum(v) / len(v) for k, v in turns.items()}}
    for name in ("plain", "sdpa"):
        out[f"{name}_us"] = device_ms(calls[name], max(2, iters // 4)) * 1e3 if calls[name] else None
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", default=None, help="root of another checkout, timed in turns with this one")
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    builds = _builds(Path(args.baseline) if args.baseline else None)
    results = []
    for i, case in enumerate(CASES):
        res = {"table": case.table, "row": case.row, "kernel": case.kernel, "shape": case.shape,
               **time_case(case, builds, args.iters, seed=i),
               "bound": {k: list(v) for k, v in case.bounds().items()}}
        results.append(res)
        if case.attention:
            h, d, t, lengths = case.shape
            shape = f"B{len(lengths)} T{t} H{h} d{d}"
        else:
            shape = f"{case.shape[0]} x {case.shape[1]}"
        turns = "; ".join(f"{k} {' '.join(f'{x:.1f}' for x in v)}" for k, v in res["us"].items())
        bound = " / ".join(f"{us:.2f} ({by})" for us, by in case.bounds().values())
        extra = "".join(f", {k[:-3]} {res[k]:.1f}" for k in ("plain_us", "sdpa_us") if res[k] is not None)
        print(f"{case.table} #{case.row} {case.kernel} {shape}: us {turns}{extra}; bound {bound}", flush=True)
    out = {"device": smi, "iters": args.iters, "results": results}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
