"""Offline sampling of DiT-MoE through the program's DiT path: guided DDIM
over whole batches, latents read back.

The program's normal path for a DiT (no sampler class, as in DiT's own
``sample.py``): ``create_diffusion(str(steps), learn_sigma=True)``,
``ddim_sample_loop`` over ``forward_with_cfg`` bound to the batch's labels
and the guidance scale, on the ``[z | z]`` batch of twice the images; the
first half is the sample. Traffic keys as ``sample.py`` reads them, with
one size: ``batch``, ``sizes``, ``sampler`` ("ddim"), ``steps``,
``cfg_scale``, ``check_images``; each batch's labels and noise come from
``sample.batch_inputs`` (the seed and the batch's index).

The model is too large for a flat fp32 draw of every weight (66 GB in
fp32 beside 33 GB in bf16), so it is built on ``meta``, cast to its
compute dtype there, allocated on the card, and loaded block by block:
block i's weights are one draw from ``weights.derive(seed,
"ditmoe.block{i}")`` (1.65 GB of fp32 at G's widths), everything outside
the blocks one more. The reference makes each block's weights again from
the same seed once the program is freed, so the card never holds the
model twice.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np

from bench_torch import common, flops, flops_moe, traffic, weights
from bench_torch.drivers.sample import K1_KERNELS, batch_inputs, check_picks
from bench_torch.reference import ditmoe as ref
from bench_torch.reference.precision import PRECISIONS
from bench_torch.trace import profiled_slice

# the kernels torch._grouped_mm runs for bf16 on SM90 (CUTLASS's grouped GEMM)
MOE_GEMM_KERNELS = ("GroupProblemShape", "grouped_mm", "GroupedGemm")
K7_KERNELS = ("moe_combine_rows",)


def dit_kwargs(m: dict) -> dict:
    """The program's ``DiT`` arguments of a configuration's ``model``."""
    return dict(
        input_size=m["input_size"], patch_size=m["patch_size"], in_channels=m["in_channels"],
        hidden_size=m["hidden_size"], depth=m["depth"], num_heads=m["num_heads"], mlp_ratio=m["mlp_ratio"],
        class_dropout_prob=m["class_dropout_prob"], num_classes=m["num_classes"], learn_sigma=m["learn_sigma"],
        num_experts=m["num_experts"], num_experts_per_tok=m["num_experts_per_tok"],
        shared_hidden=m["shared_hidden"],
    )


def outer_spec(m: dict) -> weights.Spec:
    """The leaves outside the blocks, ``nn.Linear`` layout (out, in)."""
    d = m["hidden_size"]
    pdim = m["patch_size"] ** 2 * m["in_channels"]
    out = pdim * (2 if m["learn_sigma"] else 1)
    return [
        ("x_embedder.weight", (d, pdim)), ("x_embedder.bias", (d,)),
        ("t_embedder.fc1.weight", (d, 256)), ("t_embedder.fc1.bias", (d,)),
        ("t_embedder.fc2.weight", (d, d)), ("t_embedder.fc2.bias", (d,)),
        ("y_embedder.table.weight", (m["num_classes"] + 1, d)),
        ("final.adaLN.weight", (2 * d, d)), ("final.adaLN.bias", (2 * d,)),
        ("final.linear.weight", (out, d)), ("final.linear.bias", (out,)),
    ]


def block_spec(m: dict, i: int) -> weights.Spec:
    """Block i's leaves: the backbone's in (out, in), the router (E, D), the
    experts and the shared expert in (in, out) (``models/moe.py``)."""
    d, e = m["hidden_size"], m["num_experts"]
    h, s = int(d * m["mlp_ratio"]), m["shared_hidden"]
    b = f"blocks.{i}."
    return [
        (b + "adaLN.weight", (6 * d, d)), (b + "adaLN.bias", (6 * d,)),
        (b + "attn.qkv.weight", (3 * d, d)), (b + "attn.qkv.bias", (3 * d,)),
        (b + "attn.proj.weight", (d, d)), (b + "attn.proj.bias", (d,)),
        (b + "ffn.gate", (e, d)),
        (b + "ffn.w_gate_up", (e, d, 2 * h)), (b + "ffn.w_down", (e, h, d)),
        (b + "ffn.shared_gate_up", (d, 2 * s)), (b + "ffn.shared_down", (s, d)),
    ]


def init(name: str, shape: Sequence[int]) -> Tuple[float, float]:
    """Every leaf random and none zero, as ``weights.fit_init``: fan-in
    scaled weights (the experts' fan-in is their first dim after the
    expert's), adaLN at half of that, a router whose logits spread by about
    one (fan-in scaled, so every expert gets rows), unit-scale label
    embeddings, small biases."""
    if name.endswith("bias"):
        return 0.02, 0.0
    if name == "y_embedder.table.weight":
        return 1.0, 0.0
    if name.split(".")[-1] in ("w_gate_up", "w_down", "shared_gate_up", "shared_down"):
        return 1.0 / float(np.sqrt(shape[-2])), 0.0
    scale = 0.5 if "adaLN" in name else 1.0
    return scale / float(np.sqrt(shape[1])), 0.0


def outer_weights(run, device):
    return weights.make(outer_spec(run.config["model"]), init, weights.derive(run.seed, "ditmoe.outer"), device)


def block_weights(run, i: int, device):
    return weights.make(block_spec(run.config["model"], i), init, weights.derive(run.seed, f"ditmoe.block{i}"),
                        device)


def build(run, device):
    """The program's DiT-MoE in its compute dtype on ``device``, with no
    fp32 copy of the whole model: built and cast on ``meta``, allocated,
    then loaded one block's fp32 draw at a time."""
    from fit_tpu_torch.models.dit import DiT
    from fit_tpu_torch.sampling import cast_for_sampling

    import torch

    m = run.config["model"]
    meta = torch.device("meta")
    model = cast_for_sampling(DiT(**dit_kwargs(m), dtype=common.torch_dtype(m["dtype"]), device=meta), meta)
    model.to_empty(device=device)
    weights.load_into(model, outer_weights(run, device))
    for i in range(m["depth"]):
        weights.load_into(model, block_weights(run, i, device))
    return model


def _call(run, state, labels, z, steps=None):
    """One guided DDIM run over the batch (the cell's steps unless given);
    the latents stay on the device."""
    import torch
    from fit_tpu_torch.diffusion.samplers import ddim_sample_loop

    n, model, cfg = z.shape[0], state["model"], run.traffic["cfg_scale"]
    y = torch.cat([torch.as_tensor(labels, device=z.device), torch.full((n,), model.num_classes, device=z.device)])
    diffusion = state["diffusions"][steps or run.traffic["steps"]]

    def model_fn(x, t):
        return model.forward_with_cfg(x, t, y, cfg)

    with torch.inference_mode():
        return ddim_sample_loop(diffusion, model_fn, torch.cat([z, z]), clip_denoised=False)[:n]


def setup(run) -> Dict:
    import torch
    from fit_tpu_torch.diffusion.gaussian import create_diffusion

    if run.traffic["sampler"] != "ddim" or len(run.traffic["sizes"]) != 1:
        raise ValueError("the DiT driver samples one size with DDIM")
    dev = torch.device(run.device)
    state = {"device": dev, "model": build(run, dev)}
    run.mark("weights made")
    # the warm-up: the cell's shapes through a two-step loop on the same model
    state["diffusions"] = {s: create_diffusion(str(s), learn_sigma=True) for s in (2, run.traffic["steps"])}
    labels, _, z = batch_inputs(run, -1, dev)
    _call(run, state, labels, z, steps=2).float().cpu()
    return state


def _rows(run) -> List[int]:
    """Token counts of the guided batch's rows (every image at its size)."""
    m, tr = run.config["model"], run.traffic
    h, w = tr["sizes"][0][:2]
    f = m["vae_scale"] * m["patch_size"]
    return [(h // f) * (w // f)] * (2 * tr["batch"])


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
    batch_flops = tr["steps"] * flops_moe.rows_forward_flops(m, _rows(run))
    b = 0
    while True:
        labels, _, z = batch_inputs(run, b, dev)
        ts = time.perf_counter()
        out = _call(run, state, labels, z)
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


@contextlib.contextmanager
def _block_ends():
    """Hold each sparse-MoE call's expert block ends (device tensors, read
    back only after the ``with``), to report how evenly the traced batch's
    rows spread over the experts."""
    from fit_tpu_torch.models import moe

    held: List = []
    dispatch = moe.dispatch

    def kept(idx, num_experts):
        out = dispatch(idx, num_experts)
        held.append(out[1])
        return out

    moe.dispatch = kept
    try:
        yield held
    finally:
        moe.dispatch = dispatch


def traced_slice(run, state, obs):
    """One more whole batch under the profiler."""
    import torch

    m, tr = run.config["model"], run.traffic
    labels, _, z = batch_inputs(run, 10**6, state["device"])
    rows = _rows(run)
    hd = m["hidden_size"] // m["num_heads"]
    with _block_ends() as ends:
        with profiled_slice(torch) as box:
            _call(run, state, labels, z).float().cpu()
    obs["slice_k1_bound_s"] = tr["steps"] * m["depth"] * flops.k1_bound_s(rows, m["num_heads"], hd)
    obs["k1_kernels"] = K1_KERNELS
    obs["slice_moe_gemm_bound_s"] = tr["steps"] * m["depth"] * flops_moe.expert_gemm_bound_s(m, sum(rows))
    obs["moe_gemm_kernels"] = MOE_GEMM_KERNELS
    obs["slice_k7_bound_s"] = tr["steps"] * m["depth"] * flops_moe.combine_bound_s(m, sum(rows))
    obs["k7_kernels"] = K7_KERNELS
    if ends:
        counts = np.diff(torch.stack(ends).cpu().numpy(), prepend=0, axis=1)
        skew = counts.max(axis=1) / counts.mean(axis=1)
        run.log(f"expert rows a block call, max over mean: median {np.median(skew):.4f}, "
                f"largest {skew.max():.4f}, over {len(ends)} calls; the fewest rows an expert got {counts.min()}")
    return box["trace"]


def reference_latents(run, picks, device, precision: str = "fp32") -> List[np.ndarray]:
    """The reference's latents for the picked (batch, row)s, from the same
    labels and noise, in ``precision``, all picks as one batch. Each block's
    fp32 weights are made from the seed at their first use and kept while
    the card has room for four blocks more (G's 40 blocks take 61.5 GiB once
    the program is freed), else made again at each use."""
    import torch

    m, tr = run.config["model"], run.traffic
    common.reference_mode()
    outer = outer_weights(run, device)
    block_bytes = 4 * sum(int(np.prod(shape)) for _, shape in block_spec(m, 0))
    held = {}

    def weights_of(i):
        if i in held:
            return held[i]
        w = block_weights(run, i, device)
        if device.type != "cuda" or torch.cuda.mem_get_info(device)[0] > 4 * block_bytes:
            held[i] = w
        return w

    zs, ys = [], []
    for b in sorted({b for b, _ in picks}):
        labels, _, z = batch_inputs(run, b, device)
        for bb, row in picks:
            if bb == b:
                zs.append(z[row])
                ys.append(int(labels[row]))
    z, y = torch.stack(zs), torch.tensor(ys, device=device)
    pr = PRECISIONS[precision]
    with torch.no_grad():
        x = ref.ddim(lambda x, t: ref.guided_eps(outer, m, x, t, y, tr["cfg_scale"], pr, weights_of), z, tr["steps"])
    return list(x.cpu().numpy())


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
def _attr(objs, name, value):
    saved = [getattr(o, name) for o in objs]
    for o in objs:
        setattr(o, name, value)
    try:
        yield
    finally:
        for o, v in zip(objs, saved):
            setattr(o, name, v)


@contextlib.contextmanager
def _renormalised(model):
    from fit_tpu_torch.models import moe

    route = moe.route

    def renorm(x, gate, top_k):
        idx, w = route(x, gate, top_k)
        return idx, w / w.sum(dim=-1, keepdim=True)

    moe.route = renorm
    try:
        yield
    finally:
        moe.route = route


@contextlib.contextmanager
def _no_shared(model):
    from fit_tpu_torch.models import moe

    shared = moe.SparseMoeBlock._shared
    moe.SparseMoeBlock._shared = lambda self, x2, plain: x2.new_zeros(x2.shape)
    try:
        yield
    finally:
        moe.SparseMoeBlock._shared = shared


FAULTS = {
    "fault_top1": lambda model: _attr([b.ffn for b in model.blocks], "top_k", 1),
    "fault_renormalised": _renormalised,
    "fault_no_shared": _no_shared,
}


def control(run):
    """The control's readings against the fp32 reference, on
    ``check_images`` rows of the first batch drawn from the seed: the
    reference in fp8, and the program with each planted fault (top-1
    routing, renormalised top-2 weights, the shared expert dropped)."""
    import torch

    dev = torch.device(run.device)
    n, k = run.traffic["batch"], run.traffic["check_images"]
    rows = sorted(int(r) for r in traffic.rng(run.seed, "control").choice(n, size=min(k, n), replace=False))
    labels, _, z = batch_inputs(run, 0, dev)
    state = setup(run)
    faulty = {}
    for kind, fault in FAULTS.items():
        with fault(state["model"]):
            out = _call(run, state, labels, z).float().cpu().numpy()
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
