"""DiT-MoE (Fei et al., "Scaling Diffusion Transformers to 16 Billion
Parameters", arXiv:2407.11633; github.com/feizc/DiT-MoE) as plain fp32
functions of a weight dict, with classifier-free guidance and DDIM.

The DiT backbone (Peebles & Xie, arXiv:2212.09748): p x p patches embedded
by one linear map, a fixed 2D sin-cos table added, adaLN-Zero blocks
(``Linear(D, 6D)`` of ``silu(c)``: shift, scale and gate of the attention,
then of the FFN) around an affine-free LayerNorm (eps 1e-6), attention
with a qkv bias and no mask or RoPE, and a final adaLN layer to
``p * p * 2C`` channels (eps and the learned variance). Every block's FFN
is DiT-MoE's ``SparseMoeBlock``: a bias-free router ``s = softmax(x W_g^T)``
over E experts, the top k scores ``w`` kept as they are (not renormalised),
``y = sum_k w_k E_k(x) + S(x)``, each expert and the shared expert a
bias-free SwiGLU ``W_down (silu(W_gate x) * W_up x)``. Inference is
dropless; the loop over experts below is ``moe_infer``'s.

Layouts: ``torch.nn.Linear``'s (weight (out, in)) for the backbone; the
experts stacked as ``ffn.w_gate_up`` (E, D, 2H) holding ``[gate | up]``
and ``ffn.w_down`` (E, H, D), the shared expert as ``ffn.shared_gate_up``
(D, 2S) and ``ffn.shared_down`` (S, D), each (in, out); the router as
``ffn.gate`` (E, D). A token is a p x p x C patch with the channel
fastest, tokens row-major over the patch grid.

Departures from the released code: the patch embedding is a linear map of
the (p, p, C) patch, which is the released ``Conv2d(C, D, p, stride=p)``
with its weight permuted; the router and the combine run in fp32 whatever
the model's dtype (the released ``moe_infer`` scales and sums in the
model's dtype); the two shared experts are one SwiGLU of twice the width,
which is the same function; no load-balance loss (a training term). The
released G/2 objective (eps with a learned variance, or rectified flow)
is taken as DiT's eps + learned sigma, sampled with DDIM at eta 0.

Every matmul goes through a precision object (``pr.linear(x, w, b)``,
``pr.matmul(a, b)``); :data:`FP32` is plain fp32, and the caller turns
TF32 off. This file imports nothing but torch and numpy.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

W = Dict[str, torch.Tensor]


class Fp32:
    """Plain fp32 matmuls."""

    def linear(self, x, w, b=None):
        y = x @ w.t()
        return y if b is None else y + b

    def matmul(self, a, b):
        return a @ b


FP32 = Fp32()


def patchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """(N, C, H, W) -> (N, (H/p)(W/p), p*p*C)."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // p, p, w // p, p).permute(0, 2, 4, 3, 5, 1)
    return x.reshape(n, (h // p) * (w // p), p * p * c)


def unpatchify(x: torch.Tensor, h: int, w: int, p: int, c: int) -> torch.Tensor:
    """(N, (h/p)(w/p), p*p*C) -> (N, C, h, w)."""
    n = x.shape[0]
    x = x.reshape(n, h // p, w // p, p, p, c).permute(0, 5, 1, 3, 2, 4)
    return x.reshape(n, c, h, w)


def sincos_table(dim: int, nh: int, nw: int) -> np.ndarray:
    """DiT's ``get_2d_sincos_pos_embed``: (nh*nw, dim), the first half from
    each token's width position, the second from its height, each half
    ``[sin | cos]`` of the position times ``10000**(-i/(dim/4))``."""
    pos_h, pos_w = np.divmod(np.arange(nh * nw, dtype=np.float64), nw)

    def axis(pos):
        omega = 1.0 / 10000 ** (np.arange(dim // 4, dtype=np.float64) / (dim / 4.0))
        ang = np.outer(pos, omega)
        return np.concatenate([np.sin(ang), np.cos(ang)], axis=1)

    return np.concatenate([axis(pos_w), axis(pos_h)], axis=1).astype(np.float32)


def layer_norm(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-6)


def timestep_features(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    """[cos | sin] of t times ``exp(-ln(10000) i / (dim/2))``."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def swiglu(x, w_gate_up, w_down, pr):
    gu = pr.matmul(x, w_gate_up)
    h = gu.shape[-1] // 2
    return pr.matmul(F.silu(gu[:, :h]) * gu[:, h:], w_down)


def sparse_moe(w: W, pre: str, x: torch.Tensor, top_k: int, pr=FP32) -> torch.Tensor:
    """The sparse-MoE FFN of (N, D) rows: route, then each expert over the
    rows routed to it, weighted and summed, plus the shared expert."""
    scores = torch.softmax(pr.linear(x, w[pre + "gate"]), dim=-1)
    top_w, top_i = scores.topk(top_k, dim=-1)
    y = torch.zeros_like(x)
    for e in range(w[pre + "gate"].shape[0]):
        tok, slot = (top_i == e).nonzero(as_tuple=True)
        if tok.numel():
            out = swiglu(x[tok], w[pre + "w_gate_up"][e], w[pre + "w_down"][e], pr)
            y.index_add_(0, tok, out * top_w[tok, slot, None])
    if pre + "shared_gate_up" in w:
        y = y + swiglu(x, w[pre + "shared_gate_up"], w[pre + "shared_down"], pr)
    return y


def routes(w: W, pre: str, x: torch.Tensor, top_k: int, pr=FP32) -> torch.Tensor:
    """The (N, k) expert ids :func:`sparse_moe` picks for (N, D) rows."""
    return torch.softmax(pr.linear(x, w[pre + "gate"]), dim=-1).topk(top_k, dim=-1).indices


def block(w: W, i: int, x, c, m: dict, pr=FP32):
    pre = f"blocks.{i}."
    heads, d = m["num_heads"], m["hidden_size"]
    mod = pr.linear(F.silu(c), w[pre + "adaLN.weight"], w[pre + "adaLN.bias"])
    shift_a, scale_a, gate_a, shift_f, scale_f, gate_f = mod[:, None, :].chunk(6, dim=-1)
    n, t, _ = x.shape
    hd = d // heads
    h = layer_norm(x) * (1 + scale_a) + shift_a
    q, k, v = pr.linear(h, w[pre + "attn.qkv.weight"], w[pre + "attn.qkv.bias"]).reshape(n, t, 3, heads, hd).unbind(2)
    scores = pr.matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1)) * hd**-0.5  # (N, H, T, T)
    att = pr.matmul(torch.softmax(scores, dim=-1), v.transpose(1, 2)).transpose(1, 2).reshape(n, t, d)
    x = x + gate_a * pr.linear(att, w[pre + "attn.proj.weight"], w[pre + "attn.proj.bias"])
    h = layer_norm(x) * (1 + scale_f) + shift_f
    y = sparse_moe(w, pre + "ffn.", h.reshape(n * t, d), m["num_experts_per_tok"], pr).reshape(n, t, d)
    return x + gate_f * y


def forward(w: W, m: dict, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor, pr=FP32,
            weights_of: Callable[[int], W] = None) -> torch.Tensor:
    """The model's (N, 2C, H, W) output (eps, then the variance's channels)
    for latents x (N, C, H, W) at base timesteps ``t`` and labels ``y``
    (``num_classes`` is the null class). ``weights_of(i)``, when given,
    supplies block i's weights (made per use where all would not fit)."""
    n, cin, hh, ww = x.shape
    p = m["patch_size"]
    tok = pr.linear(patchify(x, p), w["x_embedder.weight"], w["x_embedder.bias"])
    tok = tok + torch.from_numpy(sincos_table(m["hidden_size"], hh // p, ww // p)).to(x.device)[None]
    te = pr.linear(timestep_features(t), w["t_embedder.fc1.weight"], w["t_embedder.fc1.bias"])
    te = pr.linear(F.silu(te), w["t_embedder.fc2.weight"], w["t_embedder.fc2.bias"])
    c = te + w["y_embedder.table.weight"][y.long()]
    for i in range(m["depth"]):
        tok = block(weights_of(i) if weights_of else w, i, tok, c, m, pr)
    shift, scale = pr.linear(F.silu(c), w["final.adaLN.weight"], w["final.adaLN.bias"])[:, None, :].chunk(2, dim=-1)
    out = pr.linear(layer_norm(tok) * (1 + scale) + shift, w["final.linear.weight"], w["final.linear.bias"])
    return unpatchify(out, hh, ww, p, 2 * cin)


def guided_eps(w: W, m: dict, x, t, y, cfg_scale: float, pr=FP32, weights_of=None) -> torch.Tensor:
    """DiT's ``forward_with_cfg`` as its sampler reads it: the conditional
    and null-class outputs of the same latents, ``uncond + s * (cond -
    uncond)`` on the first 3 channels, the conditional eps's other channels
    as they are."""
    n = x.shape[0]
    both = forward(w, m, torch.cat([x, x]), torch.cat([t, t]), torch.cat([y, torch.full_like(y, m["num_classes"])]),
                   pr, weights_of)
    cond, uncond = both[:n, : x.shape[1]], both[n:, : x.shape[1]]
    guided = uncond[:, :3] + cfg_scale * (cond[:, :3] - uncond[:, :3])
    return torch.cat([guided, cond[:, 3:]], dim=1)


def respaced(n: int, steps: int = 1000) -> List[int]:
    """The kept timesteps of ADM's ``space_timesteps(1000, str(n))``, ascending."""
    if n == steps:
        return list(range(steps))
    stride = (steps - 1) / (n - 1)
    return sorted({round(i * stride) for i in range(n)})


def ddim(eps_fn: Callable, x: torch.Tensor, n: int) -> torch.Tensor:
    """Deterministic DDIM (eta 0, no clipping) over ADM's linear schedule
    (betas 1e-4 to 0.02 over 1000 steps) respaced to ``n`` steps, from
    noise ``x``; ``eps_fn(x, t)`` takes the base process's timestep."""
    kept = respaced(n)
    ac = np.cumprod(1.0 - np.linspace(1e-4, 0.02, 1000, dtype=np.float64))[kept]
    for i in range(len(kept) - 1, -1, -1):
        ab, ab_prev = ac[i], (ac[i - 1] if i > 0 else 1.0)
        t = torch.full((x.shape[0],), kept[i], dtype=torch.long, device=x.device)
        eps = eps_fn(x, t)
        x0 = float(np.sqrt(1.0 / ab)) * x - float(np.sqrt(1.0 / ab - 1.0)) * eps
        eps = (float(np.sqrt(1.0 / ab)) * x - x0) / float(np.sqrt(1.0 / ab - 1.0))
        x = x0 * float(np.sqrt(ab_prev)) + float(np.sqrt(1.0 - ab_prev)) * eps
    return x
