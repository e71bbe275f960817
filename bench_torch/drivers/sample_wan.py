"""Offline text-to-video sampling of Wan2.1-T2V-14B through the program's Wan
path: guided Euler steps of rectified flow, one clip a call, latents read
back.

The program's normal path (as the released ``generate.py --task t2v-14B``
samples, without its text encoder and autoencoder): ``WanModel`` from
``fit_tpu_torch.models.wan`` in its compute dtype and
``flow.denoise_guided`` over ``flow.shifted_schedule(steps, shift)``, each
step one batch of the prompt's and the negative prompt's rows. Traffic
keys: ``batch`` (clips a call), ``width``, ``height`` and ``frames`` (pixels;
the latent is (in_dim, (frames - 1) / 4 + 1, height / 8, width / 8)),
``sampler`` ("euler"), ``steps``, ``shift``, ``guide_scale``,
``prompt_tokens`` (the range a prompt's umT5 length is drawn from; its
rows past it are zeros up to ``text_len``) and ``check_clips``. Each clip's
noise, umT5 states and lengths come from the seed and the clip's index.

The model is built on ``meta``, cast there, allocated on the card and
loaded block by block (a block's weights are one draw of 1.41 GB of fp32,
``weights.derive(seed, "wan.block{i}")``). The reference makes each
block's weights again from the same seed once the program is freed.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np

from bench_torch import common, flops_wan, traffic, weights
from bench_torch.drivers.sample import K1_KERNELS
from bench_torch.reference import wan as ref
from bench_torch.reference.precision import PRECISIONS, Precision
from bench_torch.trace import profiled_slice

XATTN_KERNELS = ("cross_attention_kernel",)
# Host ranges opened at each end of the traced clip: the trace's time of each
# opening and the perf_counter() read inside it map the program's spans onto
# the trace. The slice's own opening cannot: the profiler's first range of a
# process is stamped tens of microseconds (on the CPU milliseconds) before the
# code inside it runs, and a span's last launch lies tens of microseconds
# before its end.
CLOCK = "wan.clock"
CLOCK_MARKS = 8  # at each end; the metric keeps the pair read soonest after its stamp
REF_ROOM = 16 << 30  # the reference's fp32 activations of one block over a guided pair of 32,760-token rows
QKW_KERNELS = ("qk_rms_wide_rows",)
GELU_KERNELS = ("gelu_rows",)


def wan_kwargs(m: dict) -> dict:
    """The program's ``WanModel`` arguments of a configuration's ``model``."""
    keys = ("text_len", "in_dim", "dim", "ffn_dim", "freq_dim", "text_dim", "out_dim", "num_heads", "num_layers",
            "eps", "theta")
    return dict({k: m[k] for k in keys}, patch_size=tuple(m["patch_size"]))


def outer_spec(m: dict) -> weights.Spec:
    """The leaves outside the blocks, the released names and layouts."""
    d, pd = m["dim"], flops_wan.patch_dim(m)
    out = pd // m["in_dim"] * m["out_dim"]
    return [
        ("patch_embedding.weight", (d, m["in_dim"], *m["patch_size"])), ("patch_embedding.bias", (d,)),
        ("text_embedding.0.weight", (d, m["text_dim"])), ("text_embedding.0.bias", (d,)),
        ("text_embedding.2.weight", (d, d)), ("text_embedding.2.bias", (d,)),
        ("time_embedding.0.weight", (d, m["freq_dim"])), ("time_embedding.0.bias", (d,)),
        ("time_embedding.2.weight", (d, d)), ("time_embedding.2.bias", (d,)),
        ("time_projection.1.weight", (6 * d, d)), ("time_projection.1.bias", (6 * d,)),
        ("head.head.weight", (out, d)), ("head.head.bias", (out,)),
        ("head.modulation", (1, 2, d)),
    ]


def block_spec(m: dict, prefix: str) -> weights.Spec:
    """The leaves of the block ``blocks.{i}.``."""
    d, f = m["dim"], m["ffn_dim"]
    spec: weights.Spec = []
    for a in ("self_attn", "cross_attn"):
        for p in ("q", "k", "v", "o"):
            spec += [(f"{prefix}{a}.{p}.weight", (d, d)), (f"{prefix}{a}.{p}.bias", (d,))]
        spec += [(f"{prefix}{a}.norm_q.weight", (d,)), (f"{prefix}{a}.norm_k.weight", (d,))]
    return spec + [
        (prefix + "norm3.weight", (d,)), (prefix + "norm3.bias", (d,)),
        (prefix + "ffn.0.weight", (f, d)), (prefix + "ffn.0.bias", (f,)),
        (prefix + "ffn.2.weight", (d, f)), (prefix + "ffn.2.bias", (d,)),
        (prefix + "modulation", (1, 6, d)),
    ]


def block_prefixes(m: dict) -> List[str]:
    return [f"blocks.{i}." for i in range(m["num_layers"])]


# The RMSNorm weights' mean. q and k leave the norm at unit RMS across the
# row, so each head's logits spread with about its square: at 1 attention
# over 32,760 keys is nearly uniform and a token's position or norm hardly
# moves the output; at 2 (logits of std ~4) each query weighs a few keys,
# as FLUX's cell draws its QK-norm scales.
QK_SCALE = 2.0


def init(name: str, shape: Sequence[int]) -> Tuple[float, float]:
    """Every leaf random and none zero: fan-in scaled weights (the patch
    embedding's fan-in its 64 patch values), the time projection and the
    modulations at half that, RMSNorm weights N(QK_SCALE, QK_SCALE / 10),
    norm3's weight N(1, 0.1), small biases."""
    if name.endswith(("norm_q.weight", "norm_k.weight")):
        return 0.1 * QK_SCALE, QK_SCALE
    if name.endswith("norm3.weight"):
        return 0.1, 1.0
    if name.endswith("bias"):
        return 0.02, 0.0
    if name.endswith("modulation"):
        return 0.5 / float(np.sqrt(shape[-1])), 0.0
    scale = 0.5 if name.startswith("time_projection") else 1.0
    return scale / float(np.sqrt(np.prod(shape[1:]))), 0.0


def outer_weights(run, device):
    return weights.make(outer_spec(run.config["model"]), init, weights.derive(run.seed, "wan.outer"), device)


def block_weights(run, prefix: str, device):
    tag = "wan.block" + prefix.split(".")[1]  # wan.block0 .. wan.block39
    return weights.make(block_spec(run.config["model"], prefix), init, weights.derive(run.seed, tag), device)


def build(run, device):
    """The program's Wan in its compute dtype on ``device``, loaded one
    block's fp32 draw at a time."""
    import torch
    from fit_tpu_torch.models.wan import WanModel
    from fit_tpu_torch.sampling import cast_for_sampling

    m = run.config["model"]
    meta = torch.device("meta")
    model = cast_for_sampling(WanModel(**wan_kwargs(m), dtype=common.torch_dtype(m["dtype"]), device=meta), meta)
    model.to_empty(device=device)
    weights.load_into(model, outer_weights(run, device))
    for prefix in block_prefixes(m):
        weights.load_into(model, block_weights(run, prefix, device))
    return model


def latent_shape(run) -> Tuple[int, int, int, int]:
    """(channels, frames, height, width) of a clip's latent."""
    m, tr = run.config["model"], run.traffic
    ft, st = m["vae_stride"][0], m["vae_stride"][1]
    return m["in_dim"], (tr["frames"] - 1) // ft + 1, tr["height"] // st, tr["width"] // st


def tokens(run) -> int:
    """Video tokens a row."""
    _, f, h, w = latent_shape(run)
    pf, ph, pw = run.config["model"]["patch_size"]
    return (f // pf) * (h // ph) * (w // pw)


def batch_inputs(run, b: int, device):
    """Clip batch ``b``'s (the warm-up is -1) noise (n, C, F, H, W), the
    prompts' and the negative prompts' umT5 states (n, text_len, text_dim),
    each prompt's rows past its length zero, and those lengths ((2n,) int64:
    the prompts', then the negative prompts'), fp32 normal draws and
    uniform lengths from the seed."""
    import torch

    m, n = run.config["model"], run.traffic["batch"]
    lo, hi = run.traffic["prompt_tokens"]
    lens = traffic.rng(run.seed, f"prompt{b}").integers(lo, hi + 1, size=2 * n)
    gen = torch.Generator(device).manual_seed(traffic.derive(run.seed, f"noise{b}"))
    z = torch.randn((n, *latent_shape(run)), generator=gen, device=device)
    ctx = torch.randn((2 * n, m["text_len"], m["text_dim"]), generator=gen, device=device)
    ctx *= (torch.arange(m["text_len"], device=device)[None, :] < torch.as_tensor(lens, device=device)[:, None])[..., None]
    return z, ctx[:n], ctx[n:], torch.as_tensor(lens)


def schedule(run, steps=None) -> List[float]:
    from fit_tpu_torch.diffusion.flow import shifted_schedule

    return shifted_schedule(steps or run.traffic["steps"], run.traffic["shift"])


def _call(run, model, z, ctx, ctx_null, steps=None):
    """One clip batch through ``flow.denoise_guided``; the latents stay on
    the device."""
    from fit_tpu_torch.diffusion import flow

    return flow.denoise_guided(model, z, ctx, ctx_null, schedule(run, steps), run.traffic["guide_scale"])


def setup(run) -> Dict:
    import torch

    if run.traffic["sampler"] != "euler":
        raise ValueError("the Wan driver samples with guided Euler steps")
    dev = torch.device(run.device)
    state = {"device": dev, "model": build(run, dev)}
    run.mark("weights made")
    # the warm-up: the cell's shapes through a one-step loop on the same model
    z, ctx, ctx_null, _ = batch_inputs(run, -1, dev)
    _call(run, state["model"], z, ctx, ctx_null, steps=1).float().cpu()
    return state


def window(run, state) -> Dict:
    import torch

    m, tr = run.config["model"], run.traffic
    dev = state["device"]
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run.t_window = time.time()
    t0 = time.perf_counter()
    enqueue = total = 0.0
    outputs: List[np.ndarray] = []
    batch_flops = tr["steps"] * 2 * tr["batch"] * flops_wan.forward_flops(m, tokens(run), m["text_len"])
    b = 0
    while True:
        z, ctx, ctx_null, _ = batch_inputs(run, b, dev)
        ts = time.perf_counter()
        out = _call(run, state["model"], z, ctx, ctx_null)
        tr_ = time.perf_counter()
        outputs.append(out.float().cpu().numpy())
        te = time.perf_counter()
        enqueue += tr_ - ts
        total += te - ts
        b += 1
        if te - t0 >= run.seconds:
            break
    window_s = te - t0
    clips = sum(len(o) for o in outputs)
    state["outputs"] = outputs
    state["images"] = clips
    return {
        "end_to_end": {"sample_img_per_s": clips / window_s},
        "window_s": window_s,
        "images": clips,
        "batches": b,
        "enqueue_s": enqueue,
        "batch_s": total,
        "model_flops": b * batch_flops,
    }


def _clock_mark(torch, marks: List[float]) -> None:
    for _ in range(CLOCK_MARKS):
        with torch.profiler.record_function(CLOCK):
            marks.append(time.perf_counter())


def traced_slice(run, state, obs):
    """One more whole clip batch under the profiler, ``CLOCK_MARKS``
    ``wan.clock`` marks at each end (``obs["clock_marks"]``: their
    perf_counter() readings)."""
    import torch

    m, tr = run.config["model"], run.traffic
    z, ctx, ctx_null, _ = batch_inputs(run, 10**6, state["device"])
    marks = obs["clock_marks"] = []
    with profiled_slice(torch) as box:
        _clock_mark(torch, marks)
        _call(run, state["model"], z, ctx, ctx_null).float().cpu()
        _clock_mark(torch, marks)
    rows, steps, t = 2 * tr["batch"], tr["steps"], tokens(run)
    obs["slice_k1_bound_s"] = steps * flops_wan.self_attn_bound_s(m, rows, t)
    obs["k1_kernels"] = K1_KERNELS
    obs["slice_xattn_bound_s"] = steps * flops_wan.cross_attn_bound_s(m, rows, t, m["text_len"])
    obs["xattn_kernels"] = XATTN_KERNELS
    obs["slice_qkw_bound_s"] = steps * flops_wan.qk_norm_bound_s(m, rows, t, m["text_len"])
    obs["qkw_kernels"] = QKW_KERNELS
    obs["slice_gelu_bound_s"] = steps * flops_wan.gelu_bound_s(m, rows, t)
    obs["gelu_kernels"] = GELU_KERNELS
    return box["trace"]


def _operands_in_bf16(a, b):
    """fp32 ``a @ b`` of the bf16 roundings of a and b. TF32 is exact on
    them (its 10 mantissa bits hold bf16's 7), so it runs with TF32 on."""
    import torch

    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return a.bfloat16().float() @ b.bfloat16().float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


class Bf16Operands(Precision):
    """The witness of the limit's lower edge: the reference with the stated
    configuration's bf16 rounding at every matmul and nothing else. Each
    operand is rounded to bf16 and the products are summed in fp32; a
    linear's bias is rounded too and its result rounded to bf16, as a bf16
    GEMM returns it. Norms, RoPE, softmax and the residual stay fp32. It
    shares no kernel with the program."""

    name = "bf16"

    def linear(self, x, w, b=None):
        y = _operands_in_bf16(x, w.t())
        return (y if b is None else y + b.bfloat16().float()).bfloat16().float()

    def matmul(self, a, b):
        return _operands_in_bf16(a, b)


REF_PRECISIONS = dict(PRECISIONS, bf16=Bf16Operands())


def reference_latents(run, picks, device, precision: str = "fp32") -> List[np.ndarray]:
    """The reference's latents for the picked (batch, row)s, from the same
    noise and text rows, in ``precision``, one clip at a time. Each block's
    fp32 weights are made from the seed at their first use and kept while
    the card has room for four blocks more beside ``REF_ROOM`` (all 40 take
    56.2 GB once the program is freed), else made again at each use."""
    import torch

    m = run.config["model"]
    common.reference_mode()
    outer = outer_weights(run, device)
    block_bytes = 4 * sum(int(np.prod(shape)) for _, shape in block_spec(m, "blocks.0."))
    held = {}

    def weights_of(prefix):
        if prefix in held:
            return held[prefix]
        w = block_weights(run, prefix, device)
        if device.type != "cuda" or torch.cuda.mem_get_info(device)[0] > 4 * block_bytes + REF_ROOM:
            held[prefix] = w
        return w

    cfg = dict(m, patch_size=tuple(m["patch_size"]))
    out = []
    for b, row in picks:
        z, ctx, ctx_null, _ = batch_inputs(run, b, device)
        with torch.no_grad():
            x = ref.denoise(outer, cfg, z[row : row + 1], ctx[row : row + 1], ctx_null[row : row + 1],
                            schedule(run), run.traffic["guide_scale"], REF_PRECISIONS[precision], weights_of)
        out.append(x[0].cpu().numpy())
    return out


def check(run, state):
    """The program's latents against the reference's, on clips drawn from
    the seed: the largest relative L2 gap over the sampled clips."""
    outputs = state.pop("outputs")
    state.pop("model")
    common.free_card()
    n, total = run.traffic["batch"], state["images"]
    flat = traffic.rng(run.seed, "check").choice(total, size=min(run.traffic["check_clips"], total), replace=False)
    picks = sorted((int(i) // n, int(i) % n) for i in flat)
    ref_out = reference_latents(run, picks, state["device"])
    run.mark("reference done")
    gaps = [common.rel_gap(outputs[b][row], r) for (b, row), r in zip(picks, ref_out)]
    run.log(f"latent gaps of {len(gaps)} clips: {[float(f'{g:.4g}') for g in gaps]}")
    compared = {"latent_rel_err": {"value": max(gaps), "limit": run.limits["latent_rel_err"]}}
    return compared, state["images"], 0


# -- the planted faults and the control (bench_torch.check) ------------------


@contextlib.contextmanager
def _patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


@contextlib.contextmanager
def _per_head_norm(model, lengths):
    """q and k RMS-normed head by head (FLUX's QKNorm) instead of over the
    whole row, on both routes."""
    import torch
    from fit_tpu_torch.models import wan

    heads = model.num_heads

    def per_head(x, weight, *, eps=1e-6, plain=False):
        xf = x.float().unflatten(-1, (heads, -1))
        normed = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)).flatten(-2).to(x.dtype)
        x.copy_((normed.float() * weight.float()).to(x.dtype))
        return x

    def eager(self, x):
        return per_head(x.clone(), self.weight.to(x.dtype), eps=self.eps)

    with _patched(wan, "qk_norm_wide", per_head), _patched(wan.WanRMSNorm, "forward", eager):
        yield


def _tables(change):
    """A fault in the video tokens' positions: ``change(self, batch, grid,
    device, tables)`` of the program's (cos, sin)."""
    from fit_tpu_torch.models import wan

    tables = wan.WanModel.rope_tables

    def wrong(self, batch, grid, device):
        return change(self, batch, grid, device, tables)

    return _patched(wan.WanModel, "rope_tables", wrong)


def _flux_axes(model, lengths):
    """The head dim split (16, 56, 56) between frames, rows and columns, as
    FLUX.1 splits it, in place of (44, 42, 42)."""
    from fit_tpu_torch.core.pos_embed import rope_ids_nd
    from fit_tpu_torch.ops.rope_attention import split_rope_tables

    def flux(self, batch, grid, device, tables):
        import torch

        f, h, w = grid
        axes = [torch.arange(n, device=device, dtype=torch.float32) for n in (f, h, w)]
        ids = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(1, f * h * w, 3)
        return split_rope_tables(rope_ids_nd(ids.expand(batch, -1, -1), (16, 56, 56), self.theta))

    return _tables(flux)


def _no_frame_axis(model, lengths):
    """Every token at frame 0: the frame axis's pairs do not turn."""

    def frame0(self, batch, grid, device, tables):
        return tuple(x.repeat(1, grid[0], 1) for x in tables(self, batch, (1, *grid[1:]), device))

    return _tables(frame0)


@contextlib.contextmanager
def _keys_cut(model, lengths):
    """Cross-attention's keys cut to each prompt's own length (the released
    t2v sampler attends all ``text_len`` rows, padding included)."""
    forward = model.forward
    model.forward = lambda x, t, context: forward(x, t, context, lengths)
    try:
        yield
    finally:
        del model.forward


FAULTS = {
    "fault_per_head_norm": _per_head_norm,
    "fault_flux_axes": _flux_axes,
    "fault_no_frame_axis": _no_frame_axis,
    "fault_keys_cut": _keys_cut,
}


def control(run):
    """The control's readings against the fp32 reference, on the first
    clip of the first batch: the reference in fp8, and the program with each
    planted fault (per-head QK-norm, FLUX's RoPE axes, no frame axis,
    cross-attention keys cut to the prompts' lengths); beside them, on the
    same clip, the sound program and the bf16 witness (``Bf16Operands``),
    which read the lower edge."""
    import torch

    dev = torch.device(run.device)
    z, ctx, ctx_null, lens = batch_inputs(run, 0, dev)
    lengths = lens[[0, run.traffic["batch"]]].to(dev)  # the first clip's rows: [cond | uncond]
    state = setup(run)
    got = {"program": _call(run, state["model"], z[:1], ctx[:1], ctx_null[:1]).float().cpu().numpy()[0]}
    for kind, fault in FAULTS.items():
        with fault(state["model"], lengths):
            got[kind] = _call(run, state["model"], z[:1], ctx[:1], ctx_null[:1]).float().cpu().numpy()[0]
    del state
    common.free_card()
    want = reference_latents(run, [(0, 0)], dev)[0]
    got["control_fp8"] = reference_latents(run, [(0, 0)], dev, "fp8")[0]
    got["witness_bf16"] = reference_latents(run, [(0, 0)], dev, "bf16")[0]
    return {kind: {"latent_rel_err": common.rel_gap(x, want)} for kind, x in got.items()}
