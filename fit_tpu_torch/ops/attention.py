"""Prefix-masked multi-head attention without RoPE, on (B, H, T, d) operands.

Counterpart of ``fit_tpu/ops/attention.py``: :func:`mask_to_lengths` and
:func:`masked_attention`. On a CUDA tensor :func:`masked_attention_fwd`
launches K1 (``csrc/rope_attention.cu``) with its RoPE tables null, which
replaces the blocked Pallas ``_flash_kernel``: K1 reads the (B, H, T, d)
operands by stride (views of the flat qkv projection cost no copy) and
stops each row's key loop at its length. On a CPU tensor, or with
``plain=True``, the plain version :func:`masked_attention_reference` runs
(``fit_tpu``'s ``_xla_attention``). ``fit_tpu``'s ``backend="xla" | "flash"
| "auto"`` strings are a TPU routing choice and are not ported; ``plain=``
takes their place.

The mask is a prefix mask (``[1]*n + [0]*(T-n)``) per batch row, as the
flash backend requires; :func:`masked_attention` raises on any other.
Padded query rows (at or past the length) get the softmax over the valid
keys here, zeros in ``_flash_kernel`` and the same softmax in
``_xla_attention``; all are discarded downstream. Their upstream gradient
is zeroed in the backward, as ``fit_tpu``'s ``_flash_attention_bwd`` does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from fit_tpu_torch.ops import LAUNCHES
from fit_tpu_torch.ops import rope_attention as ra

__all__ = [
    "mask_to_lengths",
    "masked_attention",
    "masked_attention_fwd",
    "masked_attention_reference",
    "masked_attention_backward_reference",
    "launches",
    "reset_launches",
]

# Launches of K1 through masked_attention_fwd since the last reset_launches(),
# read as ``launches``: the ops package's LAUNCHES["masked_attention"].


def reset_launches() -> None:
    LAUNCHES["masked_attention"] = 0


def __getattr__(name):
    if name == "launches":
        return LAUNCHES["masked_attention"]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def mask_to_lengths(mask: torch.Tensor) -> torch.Tensor:
    """(B, T) boolean prefix mask -> (B,) int32 valid lengths."""
    return mask.sum(dim=-1, dtype=torch.int32)


def masked_attention_reference(q, k, v, lengths, scale: float) -> torch.Tensor:
    """Plain PyTorch version (``fit_tpu``'s ``_xla_attention``): fp32 scores
    and softmax over the keys below each row's length, the probabilities
    cast to q's dtype before the fp32 product with v. Returns (B, H, T, d)
    in q's dtype."""
    t = q.shape[2]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    scores = scores.masked_fill(~ra._valid_keys(lengths, t, q.device), float("-inf"))
    p = torch.softmax(scores, dim=-1).to(q.dtype).float()
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def masked_attention_backward_reference(q, k, v, g, lengths, scale: float):
    """The exact recompute of ``fit_tpu``'s ``_flash_attention_bwd``, in
    fp32: dv = p^T g, ds = p (g v^T - rowsum(g o)), dq = ds k scale,
    dk = ds^T q scale, with g zeroed on query rows at or past the length.
    Returns (dq, dk, dv) in the operands' dtypes."""
    t = q.shape[2]
    keys = ra._valid_keys(lengths, t, q.device)
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.softmax(s.masked_fill(~keys, float("-inf")), dim=-1)
    gf = g.float().masked_fill(~keys.transpose(-1, -2), 0.0)  # (B, 1, T, 1) over query rows
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vf)
    ds = p * (dp - (gf * o).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def masked_attention_fwd(q, k, v, lengths, scale: float, *, plain: bool = False) -> torch.Tensor:
    """The wrapper of K1 with RoPE off, no autograd: (B, H, T, d) operands
    of any strides the kernel takes, lengths (B,) int32. The output is
    allocated as (B, T, H, d) and returned as its (B, H, T, d) view, so the
    caller's ``transpose(1, 2).reshape(B, T, H * d)`` costs no copy. On a
    CPU tensor, or with ``plain``, the plain version; on a CUDA tensor the
    kernel."""
    if plain or q.device.type == "cpu":
        return masked_attention_reference(q, k, v, lengths, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ra._check_views(qt, kt, vt)
    b, t, h, d = qt.shape
    ra._check_tables(None, None, lengths, b, t, d, q.device)
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    ra._k1_launch(qt, kt, vt, out, None, None, lengths, scale * ra.LOG2_E)
    LAUNCHES["masked_attention"] += 1
    return out.transpose(1, 2)


class _MaskedAttention(torch.autograd.Function):
    """K1 (RoPE off) forward; the backward is the exact recompute of
    ``fit_tpu``'s ``_flash_attention_bwd`` in PyTorch (``fit_tpu`` computes
    it with einsums too, outside Pallas)."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, scale, plain):
        ctx.save_for_backward(q, k, v, lengths)
        ctx.scale = scale
        return masked_attention_fwd(q, k, v, lengths, scale, plain=plain)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, lengths = ctx.saved_tensors
        dq, dk, dv = masked_attention_backward_reference(q, k, v, g, lengths, ctx.scale)
        return dq, dk, dv, None, None, None


def masked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    lengths: Optional[torch.Tensor] = None,
    plain: bool = False,
) -> torch.Tensor:
    """Scaled-dot-product attention with a prefix key mask.

    q, k, v: (B, H, T, d), possibly strided views. mask: (B, T) boolean
    prefix validity mask over keys, or None (every key valid); raises if a
    row is not a prefix mask (a check that reads the mask back to the host;
    a caller that has its lengths passes ``lengths`` (B,) int32 instead).
    scale: defaults to ``d ** -0.5``. Returns (B, H, T, d) in q's dtype (on
    the card a view of (B, T, H, d) memory), differentiable in q, k and v.
    """
    b, _, t, d = q.shape
    if scale is None:
        scale = float(d) ** -0.5
    if lengths is None:
        if mask is None:
            lengths = torch.full((b,), t, dtype=torch.int32, device=q.device)
        else:
            lengths = mask_to_lengths(mask)
            prefix = torch.arange(t, device=mask.device)[None, :] < lengths[:, None]
            if not bool((prefix == mask.bool()).all()):
                raise ValueError("masked_attention takes prefix masks only ([1]*n + [0]*(T-n) per row)")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _MaskedAttention.apply(q, k, v, lengths, scale, plain)
    return masked_attention_fwd(q, k, v, lengths, scale, plain=plain)
