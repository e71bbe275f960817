"""The reference's training: the data pipeline's packing, the masked
eps-MSE loss, gradient accumulation, AdamW and the EMA, in plain fp32.

The packing follows the FiT / masked_FiT loaders: an epoch is a
permutation drawn from ``(seed, epoch)``; batch ``i`` draws from ``(seed,
epoch, i)`` one horizontal flip a sample (p = 1/2), then in bucket packing
one token budget from the buckets and, for each longer sample, the
permutation whose first ``budget`` tokens it keeps; pad packing zero-pads
every sample to the budget. RoPE tables are the training grid's, without
VisionNTK. Each micro-batch draws, from one generator, uniform timesteps,
Gaussian noise and the label dropout (p = ``class_dropout_prob``, to the
null class), in that order.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from bench_torch.reference import diffusion
from bench_torch.reference import fit as ref_fit
from bench_torch.reference.precision import FP32, Precision


def pack_batches(latents: Sequence[np.ndarray], labels: Sequence[int], seed: int, batch: int, count: int,
                 mode: str, buckets: Sequence[int], m: dict, epoch: int = 0) -> List[Dict[str, np.ndarray]]:
    """The first ``count`` batches of ``epoch``: (B, T, p*p*C) fp32 tokens,
    (B, T, d/2, 2) tables, (B,) lengths and labels. ``latents`` are (C, h, w)
    in the loader's file order."""
    p = m["patch_size"]
    hd = m["hidden_size"] // m["num_heads"]
    budget = (m["image_size"] // m["vae_scale"] // p) ** 2
    order = np.random.default_rng((seed, epoch)).permutation(len(latents))
    out = []
    for bi in range(count):
        idxs = order[bi * batch : (bi + 1) * batch]
        r = np.random.default_rng((seed, epoch, bi))
        flips = r.random(len(idxs)) < 0.5
        n = int(r.choice(buckets)) if mode == "bucket" else budget
        tokens = np.zeros((len(idxs), n, p * p * m["in_channels"]), np.float32)
        tabs = np.zeros((len(idxs), n, hd // 2, 2), np.float32)
        lengths = np.zeros(len(idxs), np.int32)
        for j, (i, flip) in enumerate(zip(idxs, flips)):
            lat = latents[i].astype(np.float32)
            if flip:
                lat = lat[..., ::-1]
            c, h, w = lat.shape
            tok = ref_fit.patchify(torch.from_numpy(np.ascontiguousarray(lat))[None], p)[0].numpy()
            tab = ref_fit.rope_table(hd, h // p, w // p)
            t = tok.shape[0]
            if mode == "bucket" and t > n:
                keep = r.permutation(t)[:n]
                tok, tab = tok[keep], tab[keep]
            k = min(t, n)
            tokens[j, :k], tabs[j, :k], lengths[j] = tok[:k], tab[:k], k
        out.append({"tokens": tokens, "tabs": tabs, "lengths": lengths,
                    "labels": np.asarray([labels[i] for i in idxs], np.int64)})
    return out


def masked_mse(out: torch.Tensor, target: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """One mean of the squared error over every valid element of the batch."""
    keep = (torch.arange(out.shape[1], device=out.device)[None, :] < lengths[:, None]).float()[..., None]
    return ((out - target).square() * keep).sum() / (keep.sum() * out.shape[-1])


def train(w0: Dict[str, torch.Tensor], m: dict, t: dict, batches: List[dict], gen_seed: int, device,
          steps: int = 3, pr: Precision = FP32, fault: Optional[str] = None) -> dict:
    """``steps`` optimizer steps of the reference from weights ``w0`` on
    ``batches`` (one a step, split into ``grad_accum`` micro-batches).
    Returns each step's loss (the micro-batches' mean), the first step's
    gradient by leaf, and after the last step each leaf's parameters and
    EMA shadow. ``fault="half_batch"`` leaves out half of each
    micro-batch and takes the mean over the rest."""
    gen = torch.Generator(device).manual_seed(gen_seed)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in w0.items()}
    ema = {k: v.detach().clone() for k, v in w0.items()}
    exp_avg = {k: torch.zeros_like(v) for k, v in w0.items()}
    exp_avg_sq = {k: torch.zeros_like(v) for k, v in w0.items()}
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, t["learning_rate"]
    accum = t["grad_accum"]
    losses, first_grad = [], None
    for k in range(steps):
        batch = batches[k]
        micro = len(batch["labels"]) // accum
        step_losses = []
        for a in range(accum):
            sl = slice(a * micro, (a + 1) * micro)
            tokens = torch.from_numpy(batch["tokens"][sl]).to(device)
            cs = torch.from_numpy(batch["tabs"][sl]).to(device)
            lengths = torch.from_numpy(batch["lengths"][sl]).to(device)
            y = torch.from_numpy(batch["labels"][sl]).to(device)
            ts = torch.randint(0, diffusion.STEPS, (micro,), generator=gen, device=device)
            noise = torch.randn(tokens.shape, generator=gen, device=device, dtype=torch.float32)
            drop = torch.rand((micro,), generator=gen, device=device) < m["class_dropout_prob"]
            y = torch.where(drop, m["num_classes"], y)
            x_t = diffusion.q_sample(tokens, ts, noise)
            rows = slice(0, micro // 2) if fault == "half_batch" else slice(0, micro)
            out = ref_fit.forward(params, m, x_t[rows], ts[rows], y[rows], cs[rows], lengths[rows], pr,
                                  checkpoint_blocks=True)
            loss = masked_mse(out, noise[rows], lengths[rows])
            loss.backward()
            step_losses.append(float(loss.detach()))
        losses.append(float(np.mean(step_losses)))
        with torch.no_grad():
            for name, p in params.items():
                g = p.grad / accum
                if k == 0:
                    first_grad = first_grad or {}
                    first_grad[name] = g.clone()
                exp_avg[name].mul_(b1).add_(g, alpha=1 - b1)
                exp_avg_sq[name].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (exp_avg_sq[name].sqrt() / np.sqrt(1 - b2 ** (k + 1))).add_(eps)
                p.addcdiv_(exp_avg[name], denom, value=-lr / (1 - b1 ** (k + 1)))
                ema[name].mul_(t["ema_decay"]).add_(p, alpha=1 - t["ema_decay"])
                p.grad = None
    return {"losses": losses, "first_grad": first_grad, "params": {k: v.detach() for k, v in params.items()},
            "ema": ema}
