"""FLUX.1 (Black Forest Labs, github.com/black-forest-labs/flux) as plain
fp32 functions of a weight dict, with its rectified-flow Euler sampler.

Written from the released ``src/flux/model.py``, ``modules/layers.py`` and
``sampling.py``, with their parameter names (``torch.nn.Linear`` layouts,
weight (out, in)):

* ``img_in`` of the packed latent (``b c (h 2) (w 2) -> b (h w) (c 2 2)``),
  ``txt_in`` of the T5 states, ``vec = time_in(emb(1000 t)) +
  vector_in(y)``, each ``MLPEmbedder`` a Linear, SiLU, Linear, ``emb`` the
  256-wide ``[cos | sin]`` features.
* ``EmbedND``: per-token ids (text (0, 0, 0), image (0, row, col)), axis
  ``i`` rotating ``axes_dim[i] / 2`` interleaved pairs by ``id *
  theta**(-2j / axes_dim[i])``, the tables in float64 then fp32.
* ``DoubleStreamBlock``: per stream a ``Modulation`` (``Linear(D, 6D)`` of
  ``silu(vec)``: shift, scale, gate, twice), affine-free LayerNorms (eps
  1e-6), qkv with bias, ``QKNorm`` (RMSNorm of each head, eps 1e-6, times a
  learned scale), one joint attention over ``[txt | img]`` (RoPE, no
  mask), then per stream ``x += gate1 proj(attn)`` and ``x += gate2
  mlp(modulate(norm2(x)))`` with a tanh-GELU MLP.
* ``SingleStreamBlock`` on ``[txt | img]``: ``Modulation(D, 3D)``,
  ``linear1`` to ``[q | k | v | m]``, QKNorm, attention, and ``x += gate
  linear2([attn | gelu(m)])``.
* ``LastLayer``: adaLN (shift, scale), then ``Linear(D, 64)`` on the image
  rows.
* Sampling: ``get_schedule`` (evenly spaced from 1 to 0, optionally
  shifted) and Euler steps ``x += (t_next - t) v(x, t)``.

Departures from the released code: everything runs in fp32 (the RMSNorm's
cast before its scale and the bf16 timestep are the dtype's); attention is
an explicit softmax over all keys, one image at a time.

Every matmul goes through a precision object (``pr.linear(x, w, b)``,
``pr.matmul(a, b)``); :data:`FP32` is plain fp32, and :func:`forward` and
:func:`denoise` turn TF32 off. This file imports nothing but torch.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

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


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def pack(z: torch.Tensor) -> torch.Tensor:
    """(B, C, h, w) -> (B, (h/2)(w/2), C*4), channel slowest in a token."""
    b, c, h, w = z.shape
    return z.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5).reshape(b, (h // 2) * (w // 2), c * 4)


def unpack(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b, _, c4 = x.shape
    return x.reshape(b, h // 2, w // 2, c4 // 4, 2, 2).permute(0, 3, 1, 4, 2, 5).reshape(b, c4 // 4, h, w)


def image_ids(b: int, h: int, w: int, device=None) -> torch.Tensor:
    """``prepare``'s img_ids of an (h, w) latent: (B, (h/2)(w/2), 3)."""
    ids = torch.zeros(h // 2, w // 2, 3, device=device)
    ids[..., 1] = ids[..., 1] + torch.arange(h // 2, device=device)[:, None]
    ids[..., 2] = ids[..., 2] + torch.arange(w // 2, device=device)[None, :]
    return ids.reshape(1, -1, 3).repeat(b, 1, 1)


def text_ids(b: int, length: int, device=None) -> torch.Tensor:
    return torch.zeros(b, length, 3, device=device)


def get_schedule(num_steps: int, image_seq_len: int, base_shift: float = 0.5, max_shift: float = 1.15,
                 shift: bool = True) -> List[float]:
    timesteps = torch.linspace(1, 0, num_steps + 1)
    if shift:
        m = (max_shift - base_shift) / (4096 - 256)
        mu = m * image_seq_len + (base_shift - m * 256)
        timesteps = math.exp(mu) / (math.exp(mu) + (1 / timesteps - 1) ** 1.0)
    return timesteps.tolist()


def rope(pos: torch.Tensor, dim: int, theta: float) -> torch.Tensor:
    """(..., T) positions -> (..., T, dim/2, 2, 2) rotation matrices."""
    scale = torch.arange(0, dim, 2, dtype=torch.float64, device=pos.device) / dim
    omega = 1.0 / (theta**scale)
    out = torch.einsum("...n,d->...nd", pos.to(torch.float64), omega)
    out = torch.stack([torch.cos(out), -torch.sin(out), torch.sin(out), torch.cos(out)], dim=-1)
    return out.reshape(*out.shape[:-1], 2, 2).float()


def embed_nd(ids: torch.Tensor, axes_dim: Sequence[int], theta: float) -> torch.Tensor:
    """(B, T, n) ids -> (B, 1, T, d/2, 2, 2), the axes' pairs in order."""
    emb = torch.cat([rope(ids[..., i], axes_dim[i], theta) for i in range(ids.shape[-1])], dim=-3)
    return emb.unsqueeze(1)


def apply_rope(xq: torch.Tensor, xk: torch.Tensor, freqs_cis: torch.Tensor):
    xq_ = xq.float().reshape(*xq.shape[:-1], -1, 1, 2)
    xk_ = xk.float().reshape(*xk.shape[:-1], -1, 1, 2)
    xq_out = freqs_cis[..., 0] * xq_[..., 0] + freqs_cis[..., 1] * xq_[..., 1]
    xk_out = freqs_cis[..., 0] * xk_[..., 0] + freqs_cis[..., 1] * xk_[..., 1]
    return xq_out.reshape(*xq.shape), xk_out.reshape(*xk.shape)


def attention(q, k, v, pe, pr=FP32) -> torch.Tensor:
    """(B, H, T, d) q, k, v -> (B, T, H d): RoPE, then softmax attention
    over every key, one image at a time."""
    q, k = apply_rope(q, k, pe)
    scale = q.shape[-1] ** -0.5
    outs = []
    for i in range(q.shape[0]):
        scores = pr.matmul(q[i], k[i].transpose(-1, -2)) * scale
        outs.append(pr.matmul(torch.softmax(scores, dim=-1), v[i]))
    x = torch.stack(outs)
    b, h, t, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, t, h * d)


def layer_norm(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-6)


def rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) * scale


def timestep_embedding(t: torch.Tensor, dim: int = 256, max_period: int = 10000,
                       time_factor: float = 1000.0) -> torch.Tensor:
    t = time_factor * t
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(0, half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def mlp_embedder(w: W, pre: str, x, pr=FP32):
    h = pr.linear(x, w[pre + "in_layer.weight"], w[pre + "in_layer.bias"])
    return pr.linear(F.silu(h), w[pre + "out_layer.weight"], w[pre + "out_layer.bias"])


def modulation(w: W, pre: str, vec, n: int, pr=FP32):
    """``n`` (B, 1, D) chunks of ``lin(silu(vec))``."""
    out = pr.linear(F.silu(vec), w[pre + "lin.weight"], w[pre + "lin.bias"])
    return out[:, None, :].chunk(n, dim=-1)


def _heads(qkv: torch.Tensor, heads: int):
    """(B, T, 3 H d) -> q, k, v (B, H, T, d)."""
    b, t, w3 = qkv.shape
    return qkv.reshape(b, t, 3, heads, w3 // 3 // heads).permute(2, 0, 3, 1, 4).unbind(0)


def _qk_norm(w: W, pre: str, q, k):
    return rms_norm(q, w[pre + "query_norm.scale"]), rms_norm(k, w[pre + "key_norm.scale"])


def double_block(w: W, pre: str, img, txt, vec, pe, m: dict, pr=FP32):
    heads = m["num_heads"]
    mods, qkvs = {}, {}
    for s, x in (("img", img), ("txt", txt)):
        mods[s] = modulation(w, f"{pre}{s}_mod.", vec, 6, pr)
        shift1, scale1 = mods[s][0], mods[s][1]
        xm = (1 + scale1) * layer_norm(x) + shift1
        q, k, v = _heads(pr.linear(xm, w[f"{pre}{s}_attn.qkv.weight"], w.get(f"{pre}{s}_attn.qkv.bias")), heads)
        q, k = _qk_norm(w, f"{pre}{s}_attn.norm.", q, k)
        qkvs[s] = (q, k, v)
    q, k, v = (torch.cat((qkvs["txt"][i], qkvs["img"][i]), dim=2) for i in range(3))
    attn = attention(q, k, v, pe, pr)
    tt = txt.shape[1]
    outs = {}
    for s, x, a in (("img", img, attn[:, tt:]), ("txt", txt, attn[:, :tt])):
        _, _, gate1, shift2, scale2, gate2 = mods[s]
        x = x + gate1 * pr.linear(a, w[f"{pre}{s}_attn.proj.weight"], w[f"{pre}{s}_attn.proj.bias"])
        h = (1 + scale2) * layer_norm(x) + shift2
        h = pr.linear(h, w[f"{pre}{s}_mlp.0.weight"], w[f"{pre}{s}_mlp.0.bias"])
        h = pr.linear(F.gelu(h, approximate="tanh"), w[f"{pre}{s}_mlp.2.weight"], w[f"{pre}{s}_mlp.2.bias"])
        outs[s] = x + gate2 * h
    return outs["img"], outs["txt"]


def single_block(w: W, pre: str, x, vec, pe, m: dict, pr=FP32):
    d, heads = m["hidden_size"], m["num_heads"]
    shift, scale, gate = modulation(w, pre + "modulation.", vec, 3, pr)
    xm = (1 + scale) * layer_norm(x) + shift
    h = pr.linear(xm, w[pre + "linear1.weight"], w[pre + "linear1.bias"])
    qkv, mlp = h[..., : 3 * d], h[..., 3 * d :]
    q, k, v = _heads(qkv, heads)
    q, k = _qk_norm(w, pre + "norm.", q, k)
    attn = attention(q, k, v, pe, pr)
    out = pr.linear(torch.cat((attn, F.gelu(mlp, approximate="tanh")), 2), w[pre + "linear2.weight"],
                    w[pre + "linear2.bias"])
    return x + gate * out


def forward(w: W, m: dict, img, img_ids, txt, txt_ids, t, y, pr=FP32,
            weights_of: Optional[Callable[[str], W]] = None) -> torch.Tensor:
    """The velocity (B, T_img, C) of packed latents ``img`` at times ``t``
    (B,), T5 states ``txt``, pooled vector ``y`` and ids of each stream.
    ``weights_of(prefix)``, when given, supplies a block's weights (made
    per use where all would not fit)."""
    no_tf32()
    img = pr.linear(img, w["img_in.weight"], w["img_in.bias"])
    vec = mlp_embedder(w, "time_in.", timestep_embedding(t), pr) + mlp_embedder(w, "vector_in.", y, pr)
    txt = pr.linear(txt, w["txt_in.weight"], w["txt_in.bias"])
    pe = embed_nd(torch.cat((txt_ids, img_ids), dim=1), m["axes_dim"], m["theta"])
    for i in range(m["depth"]):
        pre = f"double_blocks.{i}."
        img, txt = double_block(weights_of(pre) if weights_of else w, pre, img, txt, vec, pe, m, pr)
    x = torch.cat((txt, img), 1)
    for i in range(m["depth_single_blocks"]):
        pre = f"single_blocks.{i}."
        x = single_block(weights_of(pre) if weights_of else w, pre, x, vec, pe, m, pr)
    x = x[:, txt.shape[1] :]
    shift, scale = pr.linear(F.silu(vec), w["final_layer.adaLN_modulation.1.weight"],
                             w["final_layer.adaLN_modulation.1.bias"]).chunk(2, dim=1)
    x = (1 + scale[:, None, :]) * layer_norm(x) + shift[:, None, :]
    return pr.linear(x, w["final_layer.linear.weight"], w["final_layer.linear.bias"])


def denoise(w: W, m: dict, img, img_ids, txt, txt_ids, vec, timesteps: List[float], pr=FP32,
            weights_of: Optional[Callable[[str], W]] = None) -> torch.Tensor:
    """Euler steps over ``timesteps`` from packed noise ``img``."""
    no_tf32()
    for t_curr, t_prev in zip(timesteps[:-1], timesteps[1:]):
        t_vec = torch.full((img.shape[0],), t_curr, dtype=img.dtype, device=img.device)
        pred = forward(w, m, img, img_ids, txt, txt_ids, t_vec, vec, pr, weights_of)
        img = img + (t_prev - t_curr) * pred
    return img
