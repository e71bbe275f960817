"""Offline sampling: ``FiTSampler`` over whole batches, latents read back.

Traffic keys: ``batch`` (images a call), ``sizes`` (a mix of (height,
width, share) in pixels; one size runs ``sample``, several
``sample_mixed`` on the shared canvas), ``sampler``, ``steps``,
``cfg_scale`` and ``check_images`` (how many served latents the reference
recomputes). The window runs whole batches back to back, from the first
batch's start to the last read-back; each batch's labels, sizes and noise
come from the seed and the batch's index.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from bench_torch import common, flops, traffic
from bench_torch.reference import diffusion as ref_diffusion
from bench_torch.reference import fit as ref_fit
from bench_torch.reference.precision import PRECISIONS
from bench_torch.trace import profiled_slice

K1_KERNELS = ("rope_attention_mma_kernel", "rope_attention_tf32_kernel", "rope_attention_kernel")


def _mixed(run) -> bool:
    return len(run.traffic["sizes"]) > 1


def batch_inputs(run, b: int, device):
    """Labels, sizes and initial noise of batch ``b`` (the warm-up is -1):
    (n, C, h, w) noise for one size, the (n, C, S, S) canvas for a mix."""
    import torch

    m, tr = run.config["model"], run.traffic
    n = tr["batch"]
    r = traffic.rng(run.seed, f"batch{b}")
    labels = traffic.labels(r, n, m["num_classes"])
    sizes = traffic.shuffled_sizes(tr["sizes"], n, r)
    if _mixed(run):
        shape = (n, m["in_channels"], m["max_size"], m["max_size"])
    else:
        h, w = sizes[0]
        shape = (n, m["in_channels"], h // m["vae_scale"], w // m["vae_scale"])
    gen = torch.Generator(device).manual_seed(traffic.derive(run.seed, f"noise{b}"))
    z = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return labels, sizes, z


def _call(run, sampler, labels, sizes, z):
    """One sampler call; the latents stay on the device."""
    if _mixed(run):
        return sampler.sample_mixed(labels, sizes, z=z)
    h, w = sizes[0]
    return sampler.sample(labels, h, w, z=z)


def _read_back(run, out) -> List[np.ndarray]:
    if _mixed(run):
        return [x.float().cpu().numpy() for x in out]
    return list(out.float().cpu().numpy())


def setup(run) -> Dict:
    import torch
    from fit_tpu_torch.sampling import FiTSampler

    dev = torch.device(run.device)
    m, tr = run.config["model"], run.traffic
    model = common.build_fit(run, dev)
    run.mark("weights made")
    kw = dict(cfg_scale=tr["cfg_scale"], sampler=tr["sampler"], vae_scale=m["vae_scale"], max_size=m["max_size"],
              max_length=m["max_length"], num_classes=m["num_classes"], device=dev)
    sampler = FiTSampler(model, num_sampling_steps=tr["steps"], **kw)
    # warm-up: the cell's shapes through a two-step sampler on the same model
    warm = FiTSampler(model, num_sampling_steps=2, **kw)
    labels, sizes, z = batch_inputs(run, -1, dev)
    _read_back(run, _call(run, warm, labels, sizes, z))
    return {"sampler": sampler, "device": dev}


def _valid_tokens(run, sizes) -> List[int]:
    m = run.config["model"]
    f = m["vae_scale"] * m["patch_size"]
    return [(h // f) * (w // f) for h, w in sizes]


def window(run, state) -> Dict:
    import torch

    m, tr = run.config["model"], run.traffic
    dev, sampler = state["device"], state["sampler"]
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run.t_window = time.time()
    t0 = time.perf_counter()
    enqueue = total = 0.0
    outputs: List[List[np.ndarray]] = []
    model_flops = 0.0
    k1_bound = 0.0
    hd = m["hidden_size"] // m["num_heads"]
    b = 0
    while True:
        labels, sizes, z = batch_inputs(run, b, dev)
        ts = time.perf_counter()
        out = _call(run, sampler, labels, sizes, z)
        tr_ = time.perf_counter()
        outputs.append(_read_back(run, out))
        te = time.perf_counter()
        enqueue += tr_ - ts
        total += te - ts
        lengths = _valid_tokens(run, sizes) * 2  # both halves of the guided batch
        model_flops += tr["steps"] * flops.rows_forward_flops(m, lengths)
        k1_bound += tr["steps"] * m["depth"] * flops.k1_bound_s(lengths, m["num_heads"], hd)
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
        "model_flops": model_flops,
        "k1_bound_s": k1_bound,
    }


def traced_slice(run, state, obs):
    """One more whole batch under the profiler."""
    import torch

    m, tr = run.config["model"], run.traffic
    labels, sizes, z = batch_inputs(run, 10**6, state["device"])
    lengths = _valid_tokens(run, sizes) * 2
    hd = m["hidden_size"] // m["num_heads"]
    with profiled_slice(torch) as box:
        _read_back(run, _call(run, state["sampler"], labels, sizes, z))
    obs["slice_k1_bound_s"] = tr["steps"] * m["depth"] * flops.k1_bound_s(lengths, m["num_heads"], hd)
    obs["k1_kernels"] = K1_KERNELS
    return box["trace"]


def check_picks(run, state) -> List[tuple]:
    """(batch, row) of the served latents the reference recomputes, drawn
    from the seed over every batch the window finished."""
    n = run.traffic["batch"]
    total = state["images"]
    k = min(run.traffic["check_images"], total)
    flat = traffic.rng(run.seed, "check").choice(total, size=k, replace=False)
    return sorted((int(i) // n, int(i) % n) for i in flat)


def reference_latents(run, picks, device, precision: str = "fp32") -> List[np.ndarray]:
    """The reference's latents for the picked (batch, row)s, from the same
    labels, sizes and noise, in ``precision``."""
    import torch

    m, tr = run.config["model"], run.traffic
    common.reference_mode()
    w = common.fit_weights(run, device)
    pr = PRECISIONS[precision]
    p, f = m["patch_size"], m["vae_scale"]
    items = []
    for b in sorted({b for b, _ in picks}):
        labels, sizes, z = batch_inputs(run, b, device)
        for bb, row in picks:
            if bb != b:
                continue
            h, wd = sizes[row][0] // f, sizes[row][1] // f
            tokens = ref_fit.patchify(z[row : row + 1], p)[:, : (h // p) * (wd // p)]
            items.append((int(labels[row]), (h, wd), tokens))
    sampler = {"ddim": ref_diffusion.ddim, "dpm": ref_diffusion.dpm_solver_pp_2m}[tr["sampler"]]
    out = []
    with torch.no_grad():
        for label, (h, wd), tokens in items:
            y = torch.tensor([label], device=device)
            cs = ref_fit.grid_tables(m, [(h, wd)], device, ntk=True)
            lengths = torch.tensor([tokens.shape[1]], device=device)

            def eps_fn(x, t):
                return ref_fit.guided_eps(w, m, x, t, y, cs, lengths, tr["cfg_scale"], pr)

            x = sampler(eps_fn, tokens, tr["steps"])
            out.append(ref_fit.unpatchify(x, h, wd, p, m["in_channels"])[0].cpu().numpy())
    return out


def check(run, state):
    """The program's latents against the reference's, on a sample drawn
    from the seed: the largest relative L2 gap over the sampled images."""
    outputs, images = state.pop("outputs"), state["images"]
    state.pop("sampler")
    common.free_card()
    picks = check_picks(run, state)
    ref = reference_latents(run, picks, state["device"])
    gaps = [common.rel_gap(outputs[b][row], r) for (b, row), r in zip(picks, ref)]
    run.log(f"latent gaps of {len(gaps)} images: {[float(f'{g:.4g}') for g in gaps]}")
    compared = {"latent_rel_err": {"value": max(gaps), "limit": run.limits["latent_rel_err"]}}
    return compared, images, 0


def control(run):
    """The control's reading: the reference in fp8 in the program's place,
    against the fp32 reference, on ``check_images`` rows of the first
    batch drawn from the seed."""
    import torch

    dev = torch.device(run.device)
    n, k = run.traffic["batch"], run.traffic["check_images"]
    rows = traffic.rng(run.seed, "control").choice(n, size=min(k, n), replace=False)
    picks = [(0, int(r)) for r in sorted(rows)]
    ref = reference_latents(run, picks, dev)
    low = reference_latents(run, picks, dev, "fp8")
    return {"control_fp8": {"latent_rel_err": max(common.rel_gap(a, b) for a, b in zip(low, ref))}}
