"""Fused 2D-RoPE + prefix-masked attention over the raw qkv projection.

Counterpart of the public API of ``fit_tpu/ops/fused_attention.py``:
:func:`split_rope_tables`, the rotation ``(a, b) -> (-b, a)`` on interleaved
pairs, and :func:`qkv_rope_attention` with the signature and layout of
``qkv_rope_flash_attention``. On a CUDA tensor the wrapper launches the
hand-written kernel ``csrc/rope_attention.cu`` or raises; on a CPU tensor
(or with ``plain=True``) it runs :func:`rope_attention_reference`, the plain
PyTorch version of the same function. There is no fallback from the kernel
to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from fit_tpu_torch.ops import _build

__all__ = [
    "split_rope_tables",
    "rotate_pairs",
    "rope_attention_reference",
    "qkv_rope_attention",
    "launches",
    "reset_launches",
]

LOG2_E = 1.4426950408889634  # softmax as exp2 with log2(e) folded into q

# Kernel launches made by qkv_rope_attention since the last reset_launches().
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def split_rope_tables(freqs_cis: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """Interleaved (..., d) ``[cos0, sin0, cos1, sin1, ...]`` table ->
    pair-duplicated ``cos, sin``, each (..., d) fp32 and contiguous."""
    fc = freqs_cis.float()
    cos = fc[..., 0::2].repeat_interleave(2, dim=-1)
    sin = fc[..., 1::2].repeat_interleave(2, dim=-1)
    return cos, sin


def rotate_pairs(x: torch.Tensor) -> torch.Tensor:
    """``x @ S`` of ``fit_tpu``'s ``rotation_matrix``: (a, b) -> (-b, a) per lane pair."""
    return torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1).reshape(x.shape)


def _flat_qkv(qkv: torch.Tensor) -> torch.Tensor:
    if qkv.dim() == 4:  # (B, T, 3, C): the same memory as (B, T, 3C)
        return qkv.reshape(qkv.shape[0], qkv.shape[1], -1)
    return qkv


def rope_attention_reference(
    qkv: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    lengths: torch.Tensor,
    scale: float,
    num_heads: int,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, all math in fp32.

    Softmax runs over the valid keys ``< lengths[b]`` for every query row,
    padded rows included, as the fused family does. Returns (B, T, C) in
    qkv's dtype.
    """
    qkv = _flat_qkv(qkv)
    b, t, w = qkv.shape
    c = w // 3
    d = c // num_heads
    q, k, v = qkv.float().reshape(b, t, 3, num_heads, d).unbind(2)  # (B, T, H, d)
    cos_h, sin_h = cos.float()[:, :, None, :], sin.float()[:, :, None, :]
    qr = q * cos_h + rotate_pairs(q) * sin_h
    kr = k * cos_h + rotate_pairs(k) * sin_h
    scores = torch.einsum("bqhd,bkhd->bhqk", qr, kr) * scale
    valid = torch.arange(t, device=qkv.device)[None, :] < lengths.to(qkv.device)[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return out.reshape(b, t, c).to(qkv.dtype)


def _check_cuda_args(qkv, cos, sin, lengths, num_heads, check_lengths) -> int:
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qkv must be bf16 or fp32, got {qkv.dtype}")
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv must be (B, T, 3*C) with C divisible by {num_heads} heads, got {tuple(qkv.shape)}")
    b, t, w = qkv.shape
    d = w // 3 // num_heads
    if d % 8 or d > 128:
        raise ValueError(f"the kernel takes a head_dim that is a multiple of 8, at most 128; got {d}")
    for name, tab in (("cos", cos), ("sin", sin)):
        if tab.dtype != torch.float32 or tuple(tab.shape) != (b, t, d):
            raise ValueError(f"{name} must be fp32 {(b, t, d)}, got {tab.dtype} {tuple(tab.shape)}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths must be int32 ({b},), got {lengths.dtype} {tuple(lengths.shape)}")
    for name, x in (("qkv", qkv), ("cos", cos), ("sin", sin), ("lengths", lengths)):
        if x.device != qkv.device:
            raise ValueError(f"{name} is on {x.device}, qkv on {qkv.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the kernel moves 16-byte vectors)")
    if check_lengths and bool((lengths < 1).any()):
        raise ValueError("every length must be at least 1")
    return d


def qkv_rope_attention(
    qkv: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    lengths: torch.Tensor,
    scale: float,
    num_heads: int,
    *,
    check_lengths: bool = True,
    plain: bool = False,
) -> torch.Tensor:
    """Fused RoPE + masked attention over the raw qkv projection output.

    qkv: (B, T, 3C) ``[q | k | v]``, each C block head-major
    ``[h0 | h1 | ...]`` (or the (B, T, 3, C) view of the same memory).
    cos/sin: (B, T, d) fp32 pair-duplicated tables (:func:`split_rope_tables`).
    lengths: (B,) int32 prefix lengths, each at least 1. Returns (B, T, C) in
    qkv's dtype.

    ``check_lengths=False`` skips the lengths check, which reads the tensor
    back to the host; a caller that has already checked them passes it.
    ``plain=True`` runs the plain version on any device.
    """
    global launches
    if plain or qkv.device.type == "cpu":
        return rope_attention_reference(qkv, cos, sin, lengths, scale, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"no rope attention kernel for device {qkv.device}")
    qkv = _flat_qkv(qkv)
    d = _check_cuda_args(qkv, cos, sin, lengths, num_heads, check_lengths)
    b, t, w = qkv.shape
    out = torch.empty((b, t, w // 3), dtype=qkv.dtype, device=qkv.device)
    fn = _kernel()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(
            qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            b, t, num_heads, d, scale * LOG2_E, int(qkv.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        msg = _build.load("rope_attention").rope_attention_error_string(err).decode()
        raise RuntimeError(f"rope_attention_fwd launch failed: {msg} (cudaError {err})")
    launches += 1
    return out


def _kernel():
    lib = _build.load("rope_attention")
    fn = lib.rope_attention_fwd
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ctypes.c_float, i32, ptr]
        fn.restype = i32
        lib.rope_attention_error_string.argtypes = [i32]
        lib.rope_attention_error_string.restype = ctypes.c_char_p
    return fn

