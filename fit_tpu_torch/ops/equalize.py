"""SmoothQuant activation equalization for the int8 serving path.

Counterpart of ``fit_tpu/ops/equalize.py``. The w8a8 path quantizes
activations per token, so one outlier channel inflates every row's scale.
SmoothQuant (Xiao et al. 2022, arXiv:2211.10438) moves that difficulty into
the weights: per input channel j, with calibrated activation absmax
``a_j`` and weight absmax ``w_j``, ``s_j = a_j^alpha / w_j^(1 - alpha)``
and ``X' = X / s``, ``W' = s * W`` (``X W == X' W'`` exactly). Each
division by ``s`` is folded into the parameters of the feed's producer, so
the forward costs nothing more:

=============  ==================================================
int8 feed      folded into (per block)
=============  ==================================================
attn.qkv       adaLN's msa shift and scale rows (chunks 0 and 1):
               shift / s, (1 + scale) / s - 1
attn.proj      qkv's v rows (``2C:3C`` of the flat (3C, D) weight):
               attention's output is linear in v
ffn.fc1(_g/x)  adaLN's mlp rows (chunks 3 and 4), one s for both
ffn.fc2        SwiGLU: fc1_x's rows (its output is linear in them);
               the tanh-GELU MLP skips this fold
=============  ==================================================

Calibration records the per-channel absmax of each int8 feed with forward
pre-hooks on the float model's projections; the model is not changed.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

import numpy as np
import torch

from fit_tpu_torch.core.pos_embed import rope_freqs_2d

__all__ = ["calibrate", "equalize_params", "synthetic_calib_batch"]


def synthetic_calib_batch(model, rng: np.random.Generator, batch: int, size: int):
    """A data-free calibration batch at the sampling shapes, with
    ``fit_tpu``'s numpy draws (the same batch from the same ``rng``):
    unit-gaussian latents (the diffusion marginal at high t; the channel
    structure comes from the weights), timesteps spread over the schedule,
    random labels. Returns ``(x, t, y, pos, mask)`` CPU tensors for the
    canvas forward (``train=False``)."""
    grid = size // 8 // model.patch_size
    t_tokens = grid * grid
    head_dim = model.hidden_size // model.num_heads
    x = rng.normal(size=(batch, model.in_channels, size // 8, size // 8)).astype(np.float32)
    pos = np.broadcast_to(rope_freqs_2d(head_dim, grid, grid), (batch, t_tokens, head_dim))
    t = np.linspace(20, 980, batch).astype(np.int32)
    y = rng.integers(0, model.num_classes, size=(batch,)).astype(np.int32)
    return (
        torch.from_numpy(x),
        torch.from_numpy(t),
        torch.from_numpy(y).long(),
        torch.from_numpy(pos.astype(np.float32)),
        torch.ones((batch, t_tokens), dtype=torch.bool),
    )


def _feeds(block):
    """(site, projection) pairs of one FiTBlock: the module whose input is
    each int8 feed. The tanh-GELU MLP's fc2 feed is not folded."""
    ffn = block.ffn
    feeds = [("attn_in", block.attn.qkv), ("proj_in", block.attn.proj),
             ("ffn_in", ffn.fc1_g if hasattr(ffn, "fc1_g") else ffn.fc1)]
    if hasattr(ffn, "fc1_x"):
        feeds.append(("fc2_in", ffn.fc2))
    return feeds


@torch.inference_mode()
def calibrate(model, batches: Iterable) -> Dict[str, np.ndarray]:
    """Run the float ``model`` over calibration batches and return the
    per-channel activation absmax of each int8 feed, ``{site: (depth, C)}``
    fp32, maxed over batches. ``batches`` holds ``(x, t, y, pos, mask)``
    canvas-forward inputs (:func:`synthetic_calib_batch`, or real latents),
    moved to the model's device here."""
    device = next(model.parameters()).device
    stats: Dict[str, list] = {}
    handles = []

    def record(site, i):
        def hook(_module, args):
            v = args[0].float().abs().amax(dim=tuple(range(args[0].dim() - 1)))
            row = stats.setdefault(site, [None] * len(model.blocks))
            row[i] = v if row[i] is None else torch.maximum(row[i], v)

        return hook

    for i, block in enumerate(model.blocks):
        for site, module in _feeds(block):
            handles.append(module.register_forward_pre_hook(record(site, i)))
    try:
        n = 0
        for x, t, y, pos, mask in batches:
            model(x.to(device), t.to(device), y.to(device), pos.to(device), mask.to(device), train=False)
            n += 1
    finally:
        for h in handles:
            h.remove()
    if not n:
        raise ValueError("no calibration batches supplied")
    return {site: torch.stack(rows).cpu().numpy() for site, rows in stats.items()}


def _scales(act_absmax: np.ndarray, w_absmax: np.ndarray, alpha: float) -> np.ndarray:
    a = np.maximum(act_absmax.astype(np.float64), 1e-8)
    w = np.maximum(w_absmax.astype(np.float64), 1e-8)
    s = a**alpha / w ** (1.0 - alpha)
    # dead channels (a == 0 across calibration) stay untouched
    s = np.where(act_absmax <= 0, 1.0, s)
    return np.clip(s, 1e-4, 1e4)


def _absmax(sd, key: str, axis: int) -> np.ndarray:
    return np.max(np.abs(sd[key].detach().float().cpu().numpy()), axis=axis)


def equalize_params(
    state_dict: Mapping[str, torch.Tensor], stats: Mapping[str, np.ndarray], alpha: float = 0.5
) -> Dict[str, torch.Tensor]:
    """Fold SmoothQuant scales into a float FiT state dict; the model it
    loads into computes the same function in real arithmetic (to fp32
    rounding), and its int8 feeds quantize better
    (:func:`fit_tpu_torch.ops.quant.quantize_params`, which comes after).
    Each fold runs in fp64 on the parameter and casts back to its dtype.
    Weights are (out, in): a consumer scales its input columns, a producer
    divides its output rows."""
    sd = dict(state_dict)

    def apply(key, fn):
        v = sd[key]
        out = fn(v.detach().cpu().numpy().astype(np.float64))
        sd[key] = torch.from_numpy(out.astype(np.float32)).to(device=v.device, dtype=v.dtype)

    def divide_rows(key, rows: slice, s):
        def fn(w):
            w[rows] = w[rows] / (s[:, None] if w.ndim == 2 else s)
            return w

        apply(key, fn)

    def scale_columns(key, s):
        apply(key, lambda w: w * s[None, :])

    def fold_adaln(p, s, shift_c: int, scale_c: int):
        """Divide a modulate output by s through adaLN's chunk rows."""
        d = s.shape[0]
        sh, sc = slice(shift_c * d, (shift_c + 1) * d), slice(scale_c * d, (scale_c + 1) * d)

        def weight(w):
            w[sh] = w[sh] / s[:, None]
            w[sc] = w[sc] / s[:, None]
            return w

        def bias(b):
            b[sh] = b[sh] / s
            b[sc] = (b[sc] + 1.0) / s - 1.0  # modulate uses (1 + scale)
            return b

        apply(f"{p}.adaLN.weight", weight)
        apply(f"{p}.adaLN.bias", bias)

    i = 0
    while f"blocks.{i}.adaLN.weight" in sd:
        p = f"blocks.{i}"
        # attn.qkv: modulate(...) / s, qkv's input columns * s
        s_qkv = _scales(stats["attn_in"][i], _absmax(sd, f"{p}.attn.qkv.weight", 0), alpha)
        fold_adaln(p, s_qkv, 0, 1)
        scale_columns(f"{p}.attn.qkv.weight", s_qkv)

        # attn.proj: attention's output is linear in v
        s_proj = _scales(stats["proj_in"][i], _absmax(sd, f"{p}.attn.proj.weight", 0), alpha)
        c = s_proj.shape[0]
        divide_rows(f"{p}.attn.qkv.weight", slice(2 * c, 3 * c), s_proj)
        divide_rows(f"{p}.attn.qkv.bias", slice(2 * c, 3 * c), s_proj)
        scale_columns(f"{p}.attn.proj.weight", s_proj)

        # ffn fc1 (fc1_g and fc1_x read the same rows: one s)
        swiglu = f"{p}.ffn.fc1_x.weight" in sd
        fc1 = [f"{p}.ffn.fc1_g.weight", f"{p}.ffn.fc1_x.weight"] if swiglu else [f"{p}.ffn.fc1.weight"]
        w_fc1 = np.max([_absmax(sd, k, 0) for k in fc1], axis=0)
        s_fc1 = _scales(stats["ffn_in"][i], w_fc1, alpha)
        fold_adaln(p, s_fc1, 3, 4)
        for k in fc1:
            scale_columns(k, s_fc1)

        # ffn fc2: the SwiGLU hidden silu(g) * v is linear in fc1_x's output
        if swiglu and "fc2_in" in stats:
            s_fc2 = _scales(stats["fc2_in"][i], _absmax(sd, f"{p}.ffn.fc2.weight", 0), alpha)
            h = slice(0, s_fc2.shape[0])
            divide_rows(f"{p}.ffn.fc1_x.weight", h, s_fc2)
            divide_rows(f"{p}.ffn.fc1_x.bias", h, s_fc2)
            scale_columns(f"{p}.ffn.fc2.weight", s_fc2)
        i += 1
    if i == 0:
        raise ValueError("no FiT blocks found in the state dict")
    return sd
