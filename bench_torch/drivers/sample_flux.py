"""Offline text-to-image sampling of FLUX.1-schnell through the program's
FLUX path: Euler steps of rectified flow over whole batches, latents read
back.

The program's normal path (as the released ``cli.py`` samples schnell,
without its text encoders and autoencoder): ``Flux`` from
``fit_tpu_torch.models.flux`` in its compute dtype, the noise packed 2 x 2
into tokens (``diffusion.flow.pack``) with its position ids, and
``flow.denoise`` over ``get_schedule(steps, image tokens, shift)``. Traffic
keys: ``batch`` (images a call, one row each: schnell has no guidance),
``sizes`` (one size in pixels), ``sampler`` ("euler"), ``steps``,
``shift``, ``txt_tokens`` and ``check_images``. Each batch's noise, T5
states and pooled vectors come from the seed and the batch's index.

The model is built on ``meta``, cast there, allocated on the card and
loaded block by block (a double block's weights are one draw of 1.36 GB of
fp32, ``weights.derive(seed, "flux.double{i}")``; 47.6 GB of fp32 would not
fit beside the 23.8 GB bf16 model as one draw). The reference makes each
block's weights again from the same seed once the program is freed.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np

from bench_torch import common, flops, flops_flux, traffic, weights
from bench_torch.drivers.sample import K1_KERNELS, check_picks
from bench_torch.reference import flux as ref
from bench_torch.reference.precision import PRECISIONS
from bench_torch.trace import profiled_slice

K8_KERNELS = ("qk_rms_rows",)
GELU_KERNELS = ("gelu_rows",)


def flux_kwargs(m: dict) -> dict:
    """The program's ``Flux`` arguments of a configuration's ``model``."""
    keys = ("in_channels", "vec_in_dim", "context_in_dim", "hidden_size", "mlp_ratio", "num_heads", "depth",
            "depth_single_blocks", "theta", "qkv_bias")
    return dict({k: m[k] for k in keys}, axes_dim=tuple(m["axes_dim"]))


def outer_spec(m: dict) -> weights.Spec:
    """The leaves outside the blocks, ``nn.Linear`` layout (out, in)."""
    d, c = m["hidden_size"], m["in_channels"]
    return [
        ("img_in.weight", (d, c)), ("img_in.bias", (d,)),
        ("time_in.in_layer.weight", (d, 256)), ("time_in.in_layer.bias", (d,)),
        ("time_in.out_layer.weight", (d, d)), ("time_in.out_layer.bias", (d,)),
        ("vector_in.in_layer.weight", (d, m["vec_in_dim"])), ("vector_in.in_layer.bias", (d,)),
        ("vector_in.out_layer.weight", (d, d)), ("vector_in.out_layer.bias", (d,)),
        ("txt_in.weight", (d, m["context_in_dim"])), ("txt_in.bias", (d,)),
        ("final_layer.linear.weight", (c, d)), ("final_layer.linear.bias", (c,)),
        ("final_layer.adaLN_modulation.1.weight", (2 * d, d)), ("final_layer.adaLN_modulation.1.bias", (2 * d,)),
    ]


def block_spec(m: dict, prefix: str) -> weights.Spec:
    """The leaves of the block ``double_blocks.{i}.`` or ``single_blocks.{i}.``."""
    d, hd = m["hidden_size"], m["hidden_size"] // m["num_heads"]
    h = int(d * m["mlp_ratio"])
    if prefix.startswith("double"):
        spec: weights.Spec = []
        for s in ("img", "txt"):
            p = f"{prefix}{s}_"
            spec += [
                (p + "mod.lin.weight", (6 * d, d)), (p + "mod.lin.bias", (6 * d,)),
                (p + "attn.qkv.weight", (3 * d, d)),
                *([(p + "attn.qkv.bias", (3 * d,))] if m["qkv_bias"] else []),
                (p + "attn.norm.query_norm.scale", (hd,)), (p + "attn.norm.key_norm.scale", (hd,)),
                (p + "attn.proj.weight", (d, d)), (p + "attn.proj.bias", (d,)),
                (p + "mlp.0.weight", (h, d)), (p + "mlp.0.bias", (h,)),
                (p + "mlp.2.weight", (d, h)), (p + "mlp.2.bias", (d,)),
            ]
        return spec
    return [
        (prefix + "linear1.weight", (3 * d + h, d)), (prefix + "linear1.bias", (3 * d + h,)),
        (prefix + "linear2.weight", (d, d + h)), (prefix + "linear2.bias", (d,)),
        (prefix + "norm.query_norm.scale", (hd,)), (prefix + "norm.key_norm.scale", (hd,)),
        (prefix + "modulation.lin.weight", (3 * d, d)), (prefix + "modulation.lin.bias", (3 * d,)),
    ]


def block_prefixes(m: dict) -> List[str]:
    return [f"double_blocks.{i}." for i in range(m["depth"])] + [
        f"single_blocks.{i}." for i in range(m["depth_single_blocks"])]


# The QK-norm scales' mean. q and k leave the RMSNorm at unit RMS, so the
# attention logits' spread is about its square: at 1 the attention over
# 4352 keys is nearly uniform and a key's position hardly moves the output;
# at 2 (logits of std ~4) each query weighs a few keys, and a fault in the
# rows' positions or norms reads far above the program's rounding.
QK_SCALE = 2.0


def init(name: str, shape: Sequence[int]) -> Tuple[float, float]:
    """Every leaf random and none zero: fan-in scaled weights, the
    modulations (adaLN) at half that, QK-norm scales N(QK_SCALE,
    QK_SCALE / 10), small biases."""
    if name.endswith(".scale"):
        return 0.1 * QK_SCALE, QK_SCALE
    if name.endswith("bias"):
        return 0.02, 0.0
    scale = 0.5 if ("mod" in name or "adaLN" in name) else 1.0
    return scale / float(np.sqrt(shape[1])), 0.0


def outer_weights(run, device):
    return weights.make(outer_spec(run.config["model"]), init, weights.derive(run.seed, "flux.outer"), device)


def block_weights(run, prefix: str, device):
    tag = "flux." + prefix.replace("_blocks.", "").rstrip(".")  # flux.double3, flux.single12
    return weights.make(block_spec(run.config["model"], prefix), init, weights.derive(run.seed, tag), device)


def build(run, device):
    """The program's FLUX in its compute dtype on ``device``, loaded one
    block's fp32 draw at a time."""
    import torch
    from fit_tpu_torch.models.flux import Flux
    from fit_tpu_torch.sampling import cast_for_sampling

    m = run.config["model"]
    meta = torch.device("meta")
    model = cast_for_sampling(Flux(**flux_kwargs(m), dtype=common.torch_dtype(m["dtype"]), device=meta), meta)
    model.to_empty(device=device)
    weights.load_into(model, outer_weights(run, device))
    for prefix in block_prefixes(m):
        weights.load_into(model, block_weights(run, prefix, device))
    return model


def _latent_hw(run) -> Tuple[int, int]:
    h, w = run.traffic["sizes"][0][:2]
    f = run.config["model"]["vae_scale"]
    return h // f, w // f


def _tokens(run) -> Tuple[int, int]:
    """(text tokens, image tokens) of a row."""
    h, w = _latent_hw(run)
    return run.traffic["txt_tokens"], (h // 2) * (w // 2)


def batch_inputs(run, b: int, device):
    """Batch ``b``'s (the warm-up is -1) T5 states (n, txt_tokens,
    context_in_dim), pooled vectors (n, vec_in_dim) and noise (n,
    latent_channels, h, w), fp32 normal draws from the seed."""
    import torch

    m, n = run.config["model"], run.traffic["batch"]
    h, w = _latent_hw(run)
    gen = torch.Generator(device).manual_seed(traffic.derive(run.seed, f"noise{b}"))
    z = torch.randn((n, m["latent_channels"], h, w), generator=gen, device=device)
    txt = torch.randn((n, run.traffic["txt_tokens"], m["context_in_dim"]), generator=gen, device=device)
    vec = torch.randn((n, m["vec_in_dim"]), generator=gen, device=device)
    return txt, vec, z


def schedule(run, steps=None) -> List[float]:
    from fit_tpu_torch.diffusion.flow import get_schedule

    return get_schedule(steps or run.traffic["steps"], _tokens(run)[1], shift=run.traffic["shift"])


def _call(run, model, txt, vec, z, steps=None):
    """One batch through ``flow.denoise``; the (n, C, h, w) latents stay on
    the device."""
    from fit_tpu_torch.diffusion import flow

    n, _, h, w = z.shape
    img = flow.denoise(model, flow.pack(z), flow.img_ids(n, h, w, z.device), txt,
                       flow.txt_ids(n, txt.shape[1], z.device), vec, schedule(run, steps))
    return flow.unpack(img, h, w)


def setup(run) -> Dict:
    import torch

    if run.traffic["sampler"] != "euler" or len(run.traffic["sizes"]) != 1:
        raise ValueError("the FLUX driver samples one size with Euler steps")
    dev = torch.device(run.device)
    state = {"device": dev, "model": build(run, dev)}
    run.mark("weights made")
    # the warm-up: the cell's shapes through a two-step loop on the same model
    txt, vec, z = batch_inputs(run, -1, dev)
    _call(run, state["model"], txt, vec, z, steps=2).float().cpu()
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
    batch_flops = tr["steps"] * tr["batch"] * flops_flux.forward_flops(m, *_tokens(run))
    b = 0
    while True:
        txt, vec, z = batch_inputs(run, b, dev)
        ts = time.perf_counter()
        out = _call(run, state["model"], txt, vec, z)
        tr_ = time.perf_counter()
        outputs.append(out.float().cpu().numpy())
        te = time.perf_counter()
        enqueue += tr_ - ts
        total += te - ts
        b += 1
        if te - t0 >= run.seconds:
            break
    window_s = te - t0
    images = sum(len(o) for o in outputs)
    state["outputs"] = outputs
    state["images"] = images
    return {
        "end_to_end": {"sample_img_per_s": images / window_s},
        "window_s": window_s,
        "images": images,
        "batches": b,
        "enqueue_s": enqueue,
        "batch_s": total,
        "model_flops": b * batch_flops,
    }


def traced_slice(run, state, obs):
    """One more whole batch under the profiler."""
    import torch

    m, tr = run.config["model"], run.traffic
    txt, vec, z = batch_inputs(run, 10**6, state["device"])
    with profiled_slice(torch) as box:
        _call(run, state["model"], txt, vec, z).float().cpu()
    tt, ti = _tokens(run)
    n, steps, hd = tr["batch"], tr["steps"], m["hidden_size"] // m["num_heads"]
    blocks = m["depth"] + m["depth_single_blocks"]
    obs["slice_k1_bound_s"] = steps * blocks * flops.k1_bound_s([tt + ti] * n, m["num_heads"], hd)
    obs["k1_kernels"] = K1_KERNELS
    obs["slice_k8_bound_s"] = steps * flops_flux.k8_bound_s(m, n, tt, ti)
    obs["k8_kernels"] = K8_KERNELS
    obs["slice_gelu_bound_s"] = steps * flops_flux.gelu_bound_s(m, n, tt, ti)
    obs["gelu_kernels"] = GELU_KERNELS
    return box["trace"]


def reference_latents(run, picks, device, precision: str = "fp32") -> List[np.ndarray]:
    """The reference's latents for the picked (batch, row)s, from the same
    noise and text inputs, in ``precision``, all picks as one batch. Each
    block's fp32 weights are made from the seed at their first use and kept
    while the card has room for four blocks more (all 57 take 47.6 GB once
    the program is freed), else made again at each use."""
    import torch

    m = run.config["model"]
    common.reference_mode()
    outer = outer_weights(run, device)
    block_bytes = 4 * sum(int(np.prod(shape)) for _, shape in block_spec(m, "double_blocks.0."))
    held = {}

    def weights_of(prefix):
        if prefix in held:
            return held[prefix]
        w = block_weights(run, prefix, device)
        if device.type != "cuda" or torch.cuda.mem_get_info(device)[0] > 4 * block_bytes:
            held[prefix] = w
        return w

    txts, vecs, zs = [], [], []
    for b in sorted({b for b, _ in picks}):
        txt, vec, z = batch_inputs(run, b, device)
        for bb, row in picks:
            if bb == b:
                txts.append(txt[row])
                vecs.append(vec[row])
                zs.append(z[row])
    txt, vec, z = torch.stack(txts), torch.stack(vecs), torch.stack(zs)
    n, _, h, w = z.shape
    cfg = dict(m, axes_dim=tuple(m["axes_dim"]))
    with torch.no_grad():
        x = ref.denoise(outer, cfg, ref.pack(z), ref.image_ids(n, h, w, device), txt,
                        ref.text_ids(n, txt.shape[1], device), vec, schedule(run), PRECISIONS[precision], weights_of)
    return list(ref.unpack(x, h, w).cpu().numpy())


def check(run, state):
    """The program's latents against the reference's, on a sample drawn
    from the seed: the largest relative L2 gap over the sampled images."""
    outputs = state.pop("outputs")
    state.pop("model")
    common.free_card()
    picks = check_picks(run, state)
    ref_out = reference_latents(run, picks, state["device"])
    run.mark("reference done")
    gaps = [common.rel_gap(outputs[b][row], r) for (b, row), r in zip(picks, ref_out)]
    run.log(f"latent gaps of {len(gaps)} images: {[float(f'{g:.4g}') for g in gaps]}")
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
def _no_qk_norm(model):
    """q and k go into attention as the projection left them (v copied
    into the joint buffer as before)."""
    from fit_tpu_torch.models import flux

    def copy_only(qkv, q_scale, k_scale, num_heads, *, out=None, row_offset=0, plain=False):
        if out is not None:
            out[:, row_offset : row_offset + qkv.shape[1]] = qkv[..., : out.shape[-1]]
            return out
        return qkv

    with _patched(flux, "qk_norm", copy_only), _patched(flux.QKNorm, "forward", lambda self, q, k: (q, k)):
        yield


def _tables(change):
    """A fault in the joint rows' positions: ``change(txt_ids, img_ids,
    tables)`` of the program's (cos, sin)."""
    from fit_tpu_torch.models import flux

    tables = flux.Flux.rope_tables

    def wrong(self, txt_ids, img_ids):
        return change(self, txt_ids, img_ids, tables)

    return _patched(flux.Flux, "rope_tables", wrong)


def _text_at_image_positions(model):
    """The text rows take the first image rows' positions."""
    return _tables(lambda self, txt_ids, img_ids, tables: tables(self, img_ids[:, : txt_ids.shape[1]], img_ids))


def _image_first(model):
    """The joint rows' positions in ``[img | txt]`` order, the rows
    themselves ``[txt | img]``."""
    import torch

    def swapped(self, txt_ids, img_ids, tables):
        tt = txt_ids.shape[1]
        return tuple(torch.cat([x[:, tt:], x[:, :tt]], dim=1).contiguous() for x in tables(self, txt_ids, img_ids))

    return _tables(swapped)


FAULTS = {
    "fault_no_qk_norm": _no_qk_norm,
    "fault_text_positions": _text_at_image_positions,
    "fault_image_first": _image_first,
}


def control(run):
    """The control's readings against the fp32 reference, on
    ``check_images`` rows of the first batch drawn from the seed: the
    reference in fp8, and the program with each planted fault (QK-norm
    dropped, text rows at image positions, positions in ``[img | txt]``
    order)."""
    import torch

    dev = torch.device(run.device)
    n, k = run.traffic["batch"], run.traffic["check_images"]
    rows = sorted(int(r) for r in traffic.rng(run.seed, "control").choice(n, size=min(k, n), replace=False))
    txt, vec, z = batch_inputs(run, 0, dev)
    state = setup(run)
    faulty = {}
    for kind, fault in FAULTS.items():
        with fault(state["model"]):
            out = _call(run, state["model"], txt, vec, z).float().cpu().numpy()
        faulty[kind] = [out[r] for r in rows]
    del state
    common.free_card()
    picks = [(0, r) for r in rows]
    want = reference_latents(run, picks, dev)
    low = reference_latents(run, picks, dev, "fp8")
    readings = {"control_fp8": {"latent_rel_err": max(common.rel_gap(a, b) for a, b in zip(low, want))}}
    for kind, got in faulty.items():
        readings[kind] = {"latent_rel_err": max(common.rel_gap(a, b) for a, b in zip(got, want))}
    return readings
