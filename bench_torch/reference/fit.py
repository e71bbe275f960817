"""FiT (arXiv:2402.12376) as plain fp32 functions of a weight dict.

A DiT-style transformer over packed token sequences: adaLN-Zero blocks
with an affine-free LayerNorm (eps 1e-6), one qkv projection, 2D RoPE on
q and k (the first half of each head's pairs rotates by the width
position, the second by the height; VisionNTK scales the base past the
training grid), attention over each row's valid prefix of keys, a gated
residual, and a SwiGLU FFN at 2/3 of 4x the width. Layouts follow
``torch.nn.Linear`` (weight (out, in)); a token is a p x p x C patch with
the channel fastest, and tokens run row-major over the patch grid.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bench_torch.reference.precision import FP32, Precision

W = Dict[str, torch.Tensor]


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


def rope_table(head_dim: int, nh: int, nw: int, theta: float = 10000.0,
               max_length: Optional[int] = None) -> np.ndarray:
    """(nh*nw, head_dim/2, 2) (cos, sin) of each token's rotation pairs:
    ``head_dim/4`` frequencies ``theta**(-2j/(head_dim/2))`` of the width
    position, then as many of the height position. With ``max_length``
    (sampling) each axis's base is VisionNTK's ``theta * s**(k/(k-2))``,
    ``k = head_dim/2``, ``s = max(max position / sqrt(max_length), 1)``."""
    k = head_dim // 2
    pos_h, pos_w = np.divmod(np.arange(nh * nw), nw)

    def axis(pos):
        base = theta
        if max_length is not None:
            s = max(float(pos.max()) / math.sqrt(max_length), 1.0)
            base = theta * s ** (k / (k - 2))
        freqs = 1.0 / base ** (np.arange(0, k, 2, dtype=np.float64)[: k // 2] / k)
        ang = np.outer(pos.astype(np.float64), freqs)
        return np.stack([np.cos(ang), np.sin(ang)], axis=-1)

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


def rope(x: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    """Rotate the pairs (x[2j], x[2j+1]) of (N, T, H, d) by (N, T, d/2, 2) tables."""
    n, t, h, d = x.shape
    xp = x.reshape(n, t, h, d // 2, 2)
    cos, sin = cs[:, :, None, :, 0], cs[:, :, None, :, 1]
    a, b = xp[..., 0], xp[..., 1]
    return torch.stack([a * cos - b * sin, b * cos + a * sin], dim=-1).reshape(n, t, h, d)


def block(w: W, i: int, x, c, cs, lengths, heads: int, pr: Precision):
    pre = f"blocks.{i}."
    mod = pr.linear(F.silu(c), w[pre + "adaLN.weight"], w[pre + "adaLN.bias"])
    shift_a, scale_a, gate_a, shift_f, scale_f, gate_f = mod[:, None, :].chunk(6, dim=-1)
    n, t, d = x.shape
    hd = d // heads
    h = layer_norm(x) * (1 + scale_a) + shift_a
    q, k, v = pr.linear(h, w[pre + "attn.qkv.weight"], w[pre + "attn.qkv.bias"]).reshape(n, t, 3, heads, hd).unbind(2)
    q, k = rope(q, cs), rope(k, cs)
    scores = pr.matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1)) * hd**-0.5  # (N, H, T, T)
    keep = torch.arange(t, device=x.device)[None, :] < lengths[:, None]
    scores = scores.masked_fill(~keep[:, None, None, :], float("-inf"))
    att = pr.matmul(torch.softmax(scores, dim=-1), v.transpose(1, 2)).transpose(1, 2).reshape(n, t, d)
    x = x + gate_a * pr.linear(att, w[pre + "attn.proj.weight"], w[pre + "attn.proj.bias"])
    h = layer_norm(x) * (1 + scale_f) + shift_f
    g = pr.linear(h, w[pre + "ffn.fc1_g.weight"], w[pre + "ffn.fc1_g.bias"])
    u = pr.linear(h, w[pre + "ffn.fc1_x.weight"], w[pre + "ffn.fc1_x.bias"])
    return x + gate_f * pr.linear(F.silu(g) * u, w[pre + "ffn.fc2.weight"], w[pre + "ffn.fc2.bias"])


def forward(w: W, m: dict, tokens: torch.Tensor, t: torch.Tensor, y: torch.Tensor, cs: torch.Tensor,
            lengths: torch.Tensor, pr: Precision = FP32, checkpoint_blocks: bool = False) -> torch.Tensor:
    """eps (N, T, p*p*C_out) of tokens (N, T, p*p*C) at timesteps ``t``
    and labels ``y`` (``num_classes`` is the null class), with rotation
    tables ``cs`` (N, T, d/2, 2) and valid prefix ``lengths`` (N,)."""
    x = pr.linear(tokens, w["x_embedder.weight"], w["x_embedder.bias"])
    te = pr.linear(timestep_features(t), w["t_embedder.fc1.weight"], w["t_embedder.fc1.bias"])
    te = pr.linear(F.silu(te), w["t_embedder.fc2.weight"], w["t_embedder.fc2.bias"])
    c = te + w["y_embedder.table.weight"][y.long()]
    for i in range(m["depth"]):
        if checkpoint_blocks:
            x = torch.utils.checkpoint.checkpoint(block, w, i, x, c, cs, lengths, m["num_heads"], pr,
                                                  use_reentrant=False)
        else:
            x = block(w, i, x, c, cs, lengths, m["num_heads"], pr)
    shift, scale = pr.linear(F.silu(c), w["final.adaLN.weight"], w["final.adaLN.bias"])[:, None, :].chunk(2, dim=-1)
    return pr.linear(layer_norm(x) * (1 + scale) + shift, w["final.linear.weight"], w["final.linear.bias"])


def guided_eps(w: W, m: dict, tokens, t, y, cs, lengths, cfg_scale: float, pr: Precision = FP32):
    """Classifier-free guidance: ``uncond + s * (cond - uncond)`` of the
    first C output channels, the null class being ``num_classes``."""
    n = tokens.shape[0]
    both = forward(w, m, torch.cat([tokens, tokens]), torch.cat([t, t]),
                   torch.cat([y, torch.full_like(y, m["num_classes"])]),
                   torch.cat([cs, cs]), torch.cat([lengths, lengths]), pr)
    pdim = tokens.shape[-1]
    cond, uncond = both[:n, :, :pdim], both[n:, :, :pdim]
    return uncond + cfg_scale * (cond - uncond)


def grid_tables(m: dict, sizes: Sequence[Tuple[int, int]], device, ntk: bool) -> torch.Tensor:
    """(N, T, d/2, 2) tables of latents of (h, w) sizes (all of one token count)."""
    p, hd = m["patch_size"], m["hidden_size"] // m["num_heads"]
    tabs = [rope_table(hd, h // p, w // p, max_length=m["max_length"] if ntk else None) for h, w in sizes]
    return torch.from_numpy(np.stack(tabs)).to(device)
