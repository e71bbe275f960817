"""Wan2.1 text-to-video (Wan-AI, github.com/Wan-Video/Wan2.1) as plain fp32
functions of a weight dict, with a guided Euler sampler.

Written from the released ``wan/modules/model.py`` and ``wan/text2video.py``
with their parameter names (``torch.nn.Linear`` layouts, weight (out, in);
``patch_embedding.weight`` the Conv3d's (dim, in_dim, 1, 2, 2)):

* ``patch_embedding``: Conv3d, kernel and stride (1, 2, 2), written as a
  Linear over each patch's ``in_dim * 4`` values (channel slowest); tokens
  in (frame, row, column) order.
* ``sinusoidal_embedding_1d``: ``[cos | sin]`` of ``t * 10000**(-j /
  half)`` in float64; ``e = time_embedding(...)`` (Linear, SiLU, Linear),
  ``e0 = time_projection(e)`` (SiLU, Linear to 6D), (B, 6, D).
* ``text_embedding``: Linear, tanh GELU, Linear of the (B, text_len,
  text_dim) text rows, every row attended (``context_lens`` None).
* ``rope_params`` / ``rope_apply``: 3-axis RoPE on interleaved pairs, the
  head dim's pairs split ``c - 2 (c // 3)``, ``c // 3``, ``c // 3`` between
  frames, rows and columns (c = d / 2), angles in float64.
* ``WanAttentionBlock``: ``m = modulation + e0``; ``x += self_attn(LN(x)
  (1 + m1) + m0) m2``; ``x += cross_attn(norm3(x), context)``; ``x +=
  ffn(LN(x) (1 + m4) + m3) m5``. LN affine-free, ``norm3`` with weight and
  bias, eps 1e-6. Self-attention: q, k, v, o with bias, RMSNorm of q and k
  over all D lanes times a (D,) weight, RoPE, softmax attention at scale
  d**-0.5. Cross-attention: q of x, k and v of the text rows, the same
  norms, no RoPE.
* ``Head``: ``(modulation + e)`` as (shift, scale) around an affine-free
  LN, ``Linear(D, 64)``, unpatchified channel fastest.
* Sampling: times ``shift t / (1 + (shift - 1) t)`` from 1 to 0, model
  times ``1000 t``, ``v = v_u + g (v_c - v_u)`` and Euler steps.

Departures from the released code: everything runs in fp32 (its bf16
autocast and casts are the dtype's); attention is an explicit softmax over
all keys, a batch row and a slice of queries at a time; Euler replaces
UniPC (every solver spends one guided pair of evaluations a step).

Every matmul goes through a precision object (``pr.linear(x, w, b)``,
``pr.matmul(a, b)``); :data:`FP32` is plain fp32, and :func:`forward` and
:func:`denoise` turn TF32 off. This file imports nothing but torch.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

W = Dict[str, torch.Tensor]
EPS = 1e-6
SCORE_ELEMENTS = 2**29  # the most fp32 scores one slice of queries holds (2 GiB)


class Fp32:
    """Plain fp32 matmuls."""

    def linear(self, x, w, b=None):
        y = x @ w.t()
        return y if b is None else y + b

    def matmul(self, a, b):
        return a @ b


FP32 = Fp32()


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def patchify(x: torch.Tensor) -> torch.Tensor:
    """(B, C, F, H, W) -> (B, F (H/2) (W/2), C 1 2 2), channel slowest."""
    b, c, f, h, w = x.shape
    x = x.reshape(b, c, f, 1, h // 2, 2, w // 2, 2)
    return x.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(b, f * (h // 2) * (w // 2), c * 4)


def unpatchify(x: torch.Tensor, f: int, h: int, w: int) -> torch.Tensor:
    """(B, f h w, 1 2 2 C), channel fastest -> (B, C, f, 2h, 2w)."""
    b, c = x.shape[0], x.shape[-1] // 4
    u = x.reshape(b, f, h, w, 1, 2, 2, c)
    return torch.einsum("bfhwpqrc->bcfphqwr", u).reshape(b, c, f, 2 * h, 2 * w)


def shifted_times(num_steps: int, shift: float) -> List[float]:
    t = torch.linspace(1, 0, num_steps + 1, dtype=torch.float64)
    return (shift * t / (1 + (shift - 1) * t)).tolist()


def sinusoidal_embedding_1d(dim: int, position: torch.Tensor) -> torch.Tensor:
    half = dim // 2
    position = position.to(torch.float64)
    sinusoid = torch.outer(position, torch.pow(10000, -torch.arange(half).to(position).div(half)))
    return torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=1)


def rope_params(max_seq_len: int, dim: int, theta: float = 10000.0) -> torch.Tensor:
    freqs = torch.outer(torch.arange(max_seq_len),
                        1.0 / torch.pow(theta, torch.arange(0, dim, 2).to(torch.float64).div(dim)))
    return torch.polar(torch.ones_like(freqs), freqs)


def rope_freqs(head_dim: int, max_seq_len: int = 1024, device=None) -> torch.Tensor:
    """The released ``freqs``: (max_seq_len, head_dim / 2) complex128, the
    frame axis's pairs, then the rows', then the columns'."""
    d = head_dim
    return torch.cat([rope_params(max_seq_len, d - 4 * (d // 6)), rope_params(max_seq_len, 2 * (d // 6)),
                      rope_params(max_seq_len, 2 * (d // 6))], dim=1).to(device)


def rope_apply(x: torch.Tensor, grid: Sequence[int], freqs: torch.Tensor) -> torch.Tensor:
    """x (B, L, H, d) rotated by each token's (frame, row, column) angles
    in float64; returns fp32."""
    n, c = x.size(2), x.size(3) // 2
    parts = freqs.split([c - 2 * (c // 3), c // 3, c // 3], dim=1)
    f, h, w = grid
    seq_len = f * h * w
    freqs_i = torch.cat([
        parts[0][:f].view(f, 1, 1, -1).expand(f, h, w, -1),
        parts[1][:h].view(1, h, 1, -1).expand(f, h, w, -1),
        parts[2][:w].view(1, 1, w, -1).expand(f, h, w, -1),
    ], dim=-1).reshape(seq_len, 1, -1)
    x_c = torch.view_as_complex(x.to(torch.float64).reshape(x.shape[0], seq_len, n, -1, 2))
    return torch.view_as_real(x_c * freqs_i).flatten(3).float()


def layer_norm(x, w=None, b=None) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + EPS)
    return y if w is None else y * w + b


def rms_norm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) * w


def attention(q, k, v, pr=FP32, k_lens=None) -> torch.Tensor:
    """(B, Lq, H, d) q over (B, Lk, H, d) k and v -> (B, Lq, H d): softmax
    attention at scale d**-0.5, a batch row and a slice of queries at a
    time; ``k_lens`` (B,), when given, masks keys at or past each row's."""
    b, lq, heads, d = q.shape
    lk = k.shape[1]
    scale = d**-0.5
    rows = max(1, SCORE_ELEMENTS // (heads * lk))
    out = torch.empty(b, heads, lq, d, device=q.device)
    for i in range(b):
        qi, ki, vi = (x[i].transpose(0, 1) for x in (q, k, v))  # (H, L, d)
        for s in range(0, lq, rows):
            scores = pr.matmul(qi[:, s : s + rows], ki.transpose(-1, -2)) * scale
            if k_lens is not None:
                scores[..., int(k_lens[i]) :] = float("-inf")
            out[i, :, s : s + rows] = pr.matmul(torch.softmax(scores, dim=-1), vi)
    return out.permute(0, 2, 1, 3).reshape(b, lq, heads * d)


def _lin(w: W, name: str, x, pr=FP32):
    return pr.linear(x, w[name + ".weight"], w[name + ".bias"])


def self_attn(w: W, pre: str, x, grid, freqs, heads: int, pr=FP32):
    b, s, dim = x.shape
    q = rms_norm(_lin(w, pre + "q", x, pr), w[pre + "norm_q.weight"]).view(b, s, heads, -1)
    k = rms_norm(_lin(w, pre + "k", x, pr), w[pre + "norm_k.weight"]).view(b, s, heads, -1)
    v = _lin(w, pre + "v", x, pr).view(b, s, heads, -1)
    o = attention(rope_apply(q, grid, freqs), rope_apply(k, grid, freqs), v, pr)
    return _lin(w, pre + "o", o, pr)


def cross_attn(w: W, pre: str, x, context, heads: int, pr=FP32, context_lens=None):
    b = x.shape[0]
    q = rms_norm(_lin(w, pre + "q", x, pr), w[pre + "norm_q.weight"]).view(b, -1, heads, x.shape[-1] // heads)
    k = rms_norm(_lin(w, pre + "k", context, pr), w[pre + "norm_k.weight"]).view(b, -1, heads, x.shape[-1] // heads)
    v = _lin(w, pre + "v", context, pr).view(b, -1, heads, x.shape[-1] // heads)
    return _lin(w, pre + "o", attention(q, k, v, pr, context_lens), pr)


def block(w: W, pre: str, x, e0, grid, freqs, context, m: dict, pr=FP32, context_lens=None):
    heads = m["num_heads"]
    e = (w[pre + "modulation"] + e0).chunk(6, dim=1)  # six (B, 1, D)
    y = self_attn(w, pre + "self_attn.", layer_norm(x) * (1 + e[1]) + e[0], grid, freqs, heads, pr)
    x = x + y * e[2]
    x = x + cross_attn(w, pre + "cross_attn.", layer_norm(x, w[pre + "norm3.weight"], w[pre + "norm3.bias"]),
                       context, heads, pr, context_lens)
    h = _lin(w, pre + "ffn.0", layer_norm(x) * (1 + e[4]) + e[3], pr)
    y = _lin(w, pre + "ffn.2", F.gelu(h, approximate="tanh"), pr)
    return x + y * e[5]


def forward(w: W, m: dict, x, t, context, pr=FP32, weights_of: Optional[Callable[[str], W]] = None,
            context_lens=None) -> torch.Tensor:
    """The velocity (B, C, F, H, W) of latents ``x`` (B, C, F, H, W) at
    timesteps ``t`` (B,) in [0, 1000], with text rows ``context`` (B,
    text_len, text_dim). ``weights_of(prefix)``, when given, supplies a
    block's weights (made per use where all would not fit)."""
    no_tf32()
    dim = m["dim"]
    b, _, f, hh, ww = x.shape
    grid = (f, hh // 2, ww // 2)
    tokens = pr.linear(patchify(x), w["patch_embedding.weight"].reshape(dim, -1), w["patch_embedding.bias"])
    e = _lin(w, "time_embedding.2", F.silu(_lin(w, "time_embedding.0",
                                                sinusoidal_embedding_1d(m["freq_dim"], t).float(), pr)), pr)
    e0 = _lin(w, "time_projection.1", F.silu(e), pr).unflatten(1, (6, dim))
    ctx = _lin(w, "text_embedding.2", F.gelu(_lin(w, "text_embedding.0", context, pr), approximate="tanh"), pr)
    freqs = rope_freqs(dim // m["num_heads"], device=x.device)
    for i in range(m["num_layers"]):
        pre = f"blocks.{i}."
        tokens = block(weights_of(pre) if weights_of else w, pre, tokens, e0, grid, freqs, ctx, m, pr, context_lens)
    n = (w["head.modulation"] + e.unsqueeze(1)).chunk(2, dim=1)
    out = _lin(w, "head.head", layer_norm(tokens) * (1 + n[1]) + n[0], pr)
    return unpatchify(out, *grid)


def denoise(w: W, m: dict, z, context, context_null, times: List[float], guide_scale: float, pr=FP32,
            weights_of: Optional[Callable[[str], W]] = None) -> torch.Tensor:
    """Guided Euler steps over ``times`` from noise ``z`` (B, C, F, H, W):
    each step the prompt's and the negative prompt's velocity, one batch."""
    no_tf32()
    n = z.shape[0]
    ctx = torch.cat((context, context_null))
    for t_curr, t_prev in zip(times[:-1], times[1:]):
        t_vec = torch.full((2 * n,), 1000.0 * t_curr, device=z.device)
        cond, uncond = forward(w, m, torch.cat((z, z)), t_vec, ctx, pr, weights_of).chunk(2)
        z = z + (t_prev - t_curr) * (uncond + guide_scale * (cond - uncond))
    return z
