"""Fused 2D-RoPE + prefix-masked attention over the raw qkv projection, and
its backward.

Counterpart of the public API of ``fit_tpu/ops/fused_attention.py``:
:func:`split_rope_tables`, the rotation ``(a, b) -> (-b, a)`` on interleaved
pairs, :func:`qkv_rope_attention` with the signature and layout of
``qkv_rope_flash_attention``, and :func:`rope_flash_attention` with that of
``rope_flash_attention`` on (B, T, H, d) operands, both differentiable as
their ``jax.custom_vjp`` is.

Two kernels:

* K1 -> ``csrc/rope_attention.cu``: the forward on (B, T, H, d) operands
  read by stride (bf16 on ``wgmma`` fed by TMA, after a pre-pass that
  rotates K once into scratch the wrapper allocates,
  ``csrc/rope_attention_sm90.cuh``; fp32 on ``mma.sync`` TF32 tiles, three
  products each for fp32 accuracy, ``csrc/rope_attention_tf32.cuh``), with
  RoPE or (null tables) without it, optionally with each row's
  log2-sum-exp ``lse2``
  (B, T, H) fp32, the residual of the backward
  (``_qkv_forward_chunked(..., with_lse=True)``). Three wrappers
  launch it, each counted under its own name in ``ops.LAUNCHES``:
  :func:`rope_attention_fwd` (the packed projection),
  :func:`rope_flash_attention` and
  ``fit_tpu_torch.ops.attention.masked_attention`` (RoPE off); the bf16
  K pre-pass counts as ``rope_attention_rotate_k``, once a call with RoPE.
  :func:`cross_attention` (bf16) runs the same key loop over keys and
  values of a sequence of their own, without RoPE, as a kernel of its own
  name (``cross_attention_kernel_sm90``), counted as "cross_attention".
* K2, :func:`rope_attention_bwd` -> ``csrc/rope_attention_bwd.cu``: dqkv
  (B, T, 3C) from ``(qkv, g, out, lse2)``, at any T: a prologue into
  scratch the wrapper allocates, then dk/dv and dq passes on ``mma.sync``
  tensor-core tiles (bf16, ``csrc/rope_attention_bwd_mma.cuh``; fp32 as
  three TF32 products each, ``csrc/rope_attention_bwd_tf32.cuh``).

:func:`qkv_rope_attention` is a ``torch.autograd.Function`` over the pair
when a gradient is wanted (K1 with lse, then K2), and K1 alone without lse
otherwise (``torch.inference_mode``, ``no_grad``, or an input that needs no
gradient). On a CUDA tensor a wrapper launches its kernel or raises; on a
CPU tensor (or with ``plain=True``) it runs the plain PyTorch version of the
same formulas, :func:`rope_attention_reference` and
:func:`rope_attention_backward_reference`. There is no fallback from a
kernel to its plain version.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from fit_tpu_torch.ops import LAUNCHES, _build

__all__ = [
    "split_rope_tables",
    "rotate_pairs",
    "rope_attention_reference",
    "rope_attention_backward_reference",
    "rope_flash_reference",
    "rope_attention_fwd",
    "rope_attention_bwd",
    "qkv_rope_attention",
    "rope_flash_attention",
    "cross_attention",
    "cross_attention_reference",
]

LOG2_E = 1.4426950408889634  # softmax as exp2 with log2(e) folded into q

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


def _rope_heads(x, cos, sin):
    """fp32 rope(x) of a (B, T, H, d) operand, with (B, T, d) tables."""
    x = x.float()
    return x * cos.float()[:, :, None, :] + rotate_pairs(x) * sin.float()[:, :, None, :]


def _rotated_heads(qkv, cos, sin, num_heads):
    """fp32 (B, T, H, d) rope(q), rope(k) and v of a (B, T, 3C) projection."""
    b, t, w = qkv.shape
    d = w // 3 // num_heads
    q, k, v = qkv.float().reshape(b, t, 3, num_heads, d).unbind(2)
    return _rope_heads(q, cos, sin), _rope_heads(k, cos, sin), v


def _softmax_attention(qr, kr, v, lengths, scale, with_lse):
    """fp32 (B, Tq, H, d) attention of rotated q over (B, Tk, H, d) rotated
    k and v, the keys below each row's length, for every query row; with
    ``with_lse`` also lse2."""
    scores = torch.einsum("bqhd,bkhd->bhqk", qr, kr) * scale
    scores = scores.masked_fill(~_valid_keys(lengths, kr.shape[1], qr.device), float("-inf"))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v.float())
    if not with_lse:
        return out, None
    return out, (torch.logsumexp(scores, dim=-1) * LOG2_E).transpose(1, 2).contiguous()


def _valid_keys(lengths, t, device) -> torch.Tensor:
    """(B, 1, 1, T) mask of the keys below each row's length."""
    valid = torch.arange(t, device=device)[None, :] < lengths.to(device)[:, None]
    return valid[:, None, None, :]


def rope_attention_reference(
    qkv: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    lengths: torch.Tensor,
    scale: float,
    num_heads: int,
    *,
    with_lse: bool = False,
):
    """Plain PyTorch version of K1, all math in fp32.

    Softmax runs over the valid keys ``< lengths[b]`` for every query row,
    padded rows included, as the fused family does. Returns (B, T, C) in
    qkv's dtype, and with ``with_lse`` also ``lse2`` (B, T, H) fp32: the
    log2-sum-exp of each row's scores in the exp2 domain, so that
    ``softmax = exp2(scores * log2(e) - lse2)``.
    """
    qkv = _flat_qkv(qkv)
    b, t, w = qkv.shape
    out, lse2 = _softmax_attention(*_rotated_heads(qkv, cos, sin, num_heads), lengths, scale, with_lse)
    out = out.reshape(b, t, w // 3).to(qkv.dtype)
    return (out, lse2) if with_lse else out


def rope_flash_reference(q, k, v, cos, sin, lengths, scale) -> torch.Tensor:
    """Plain PyTorch version of K1 on (B, T, H, d) operands, all math in
    fp32 (``fit_tpu``'s ``_xla_reference``). Returns (B, T, H, d) in q's
    dtype."""
    out, _ = _softmax_attention(_rope_heads(q, cos, sin), _rope_heads(k, cos, sin), v, lengths, scale, False)
    return out.to(q.dtype)


def rope_attention_backward_reference(
    qkv: torch.Tensor,
    g: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    lengths: torch.Tensor,
    scale: float,
    num_heads: int,
) -> torch.Tensor:
    """Plain PyTorch version of K2, all math in fp32: the VJP of K1 at
    ``qkv`` for the upstream gradient ``g`` (B, T, C), from the forward's
    ``out`` and ``lse2``. Returns dqkv (B, T, 3C) in qkv's dtype.

    p = exp2(s2 - lse2) over the valid keys (s2 the scores times log2(e)),
    dv = p^T g, ds = p (g v^T - rowsum(g out)), dq_r = ds k_r scale,
    dk_r = ds^T q_r scale, and the RoPE VJP ``x cos - rot(x sin)`` (the
    rotation is antisymmetric), as ``fit_tpu``'s ``_qkv_bwd_kernel``.
    """
    qkv = _flat_qkv(qkv)
    b, t, w = qkv.shape
    c = w // 3
    d = c // num_heads
    qr, kr, v = _rotated_heads(qkv, cos, sin, num_heads)
    gf = g.float().reshape(b, t, num_heads, d)
    of = out.float().reshape(b, t, num_heads, d)
    s2 = torch.einsum("bqhd,bkhd->bhqk", qr, kr) * (scale * LOG2_E)
    p = torch.exp2(s2 - lse.float().transpose(1, 2)[..., None])
    p = p.masked_fill(~_valid_keys(lengths, t, qkv.device), 0.0)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, v)
    delta = (gf * of).sum(-1).transpose(1, 2)[..., None]  # (B, H, T, 1)
    ds = p * (dp - delta)
    dqr = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
    dkr = torch.einsum("bhqk,bqhd->bkhd", ds, qr) * scale
    cos_h, sin_h = cos.float()[:, :, None, :], sin.float()[:, :, None, :]

    def rope_vjp(x):
        return x * cos_h - rotate_pairs(x * sin_h)

    dqkv = torch.stack([rope_vjp(dqr), rope_vjp(dkr), dv], dim=2)  # (B, T, 3, H, d)
    return dqkv.reshape(b, t, w).to(qkv.dtype)


def _check_head_dim(d: int) -> None:
    if d % 8 or d > 128:
        raise ValueError(f"the kernel takes a head_dim that is a multiple of 8, at most 128; got {d}")


def _check_tables(cos, sin, lengths, b, t, d, device) -> None:
    """cos/sin (B, T, d) fp32 (or both None: no RoPE) and lengths (B,) int32,
    contiguous and 16-byte aligned on ``device``."""
    if (cos is None) != (sin is None):
        raise ValueError("cos and sin are both tables or both None")
    for name, tab in (("cos", cos), ("sin", sin)):
        if tab is None:
            continue
        if tab.dtype != torch.float32 or tuple(tab.shape) != (b, t, d):
            raise ValueError(f"{name} must be fp32 {(b, t, d)}, got {tab.dtype} {tuple(tab.shape)}")
        _check_operand(name, tab, device)
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths must be int32 ({b},), got {lengths.dtype} {tuple(lengths.shape)}")
    _check_operand("lengths", lengths, device)


def _check_cuda_args(qkv, cos, sin, lengths, num_heads, check_lengths) -> int:
    """The packed (B, T, 3C) projection of K1's packed entry and of K2,
    which reads and writes it contiguous."""
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qkv must be bf16 or fp32, got {qkv.dtype}")
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv must be (B, T, 3*C) with C divisible by {num_heads} heads, got {tuple(qkv.shape)}")
    b, t, w = qkv.shape
    d = w // 3 // num_heads
    _check_head_dim(d)
    _check_tables(cos, sin, lengths, b, t, d, qkv.device)
    _check_operand("qkv", qkv, qkv.device)
    if check_lengths and bool((lengths < 1).any()):
        raise ValueError("every length must be at least 1")
    return d


def _check_operand(name: str, x: torch.Tensor, device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, qkv on {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (the kernel moves 16-byte vectors)")


def _bth_strides(x: torch.Tensor) -> "list[int]":
    """The batch, token and head element strides of a (B, T, H, d) operand;
    a dim of size 1 is never stepped over, so its stride is 0."""
    return [st if n > 1 else 0 for n, st in zip(x.shape[:3], x.stride()[:3])]


def _check_views(q, k, v, out=None) -> None:
    """(B, T, H, d) operands of any strides that K1 reads (or, ``out``,
    writes) as they are: one dtype, shape and device, the head dim
    contiguous, the batch, token and head strides multiples of 8 elements
    and each base 16-byte aligned, so every row segment moves as 16-byte
    vectors."""
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bf16 or fp32, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q, k, v must be (B, T, H, d), got {tuple(q.shape)}")
    _check_head_dim(q.shape[-1])
    for name, x in (("q", q), ("k", k), ("v", v)) + ((("out", out),) if out is not None else ()):
        if x.dtype != q.dtype or x.shape != q.shape or x.device != q.device:
            raise ValueError(f"{name} is {x.dtype} {tuple(x.shape)} on {x.device}; q is {q.dtype} {tuple(q.shape)} on {q.device}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous (stride 1), got strides {x.stride()}")
        if any(st % 8 for st in _bth_strides(x)):
            raise ValueError(f"{name}'s batch, token and head strides must be multiples of 8 elements, got {x.stride()}")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the kernel moves 16-byte vectors)")


K1_PADDINGS = (16, 32, 64, 80, 128)  # the compiled head-dim paddings: d pads to the smallest >= d
K1_KEY_TILE = 128  # the bf16 kernel's keys a tile


def _k1_scratch(k: torch.Tensor) -> torch.Tensor:
    """The bf16 K1's rotated-K scratch for a (B, T, H, d) operand: (B, H, T
    rounded up to the key tile, DP) bf16, DP the padding of d (FLUX.1's B 4,
    T 4352, H 24, d 128: 107 MB)."""
    b, t, h, d = k.shape
    dp = next(p for p in K1_PADDINGS if p >= d)
    t_pad = -(-t // K1_KEY_TILE) * K1_KEY_TILE
    return torch.empty((b, h, t_pad, dp), dtype=torch.bfloat16, device=k.device)


def _k1_launch(q, k, v, out, cos, sin, lengths, q_mul, lse=None) -> None:
    """Launches K1 on (B, T, H, d) operands that the caller has checked
    (:func:`_check_views`, :func:`_check_tables`), writing ``out`` (B, T, H,
    d, any strides the checks allow) and, when given, ``lse`` (B, T, H)
    fp32. ``cos`` None runs attention without RoPE. Raises if the launch
    fails. Counts the bf16 K pre-pass (``rope_attention_rotate_k``, with
    RoPE); each entry counts its own call."""
    b, t, h, d = q.shape
    lib = _lib("rope_attention")
    strides = [st for x in (q, k, v, out) for st in _bth_strides(x)]
    bf16 = q.dtype == torch.bfloat16
    kscratch = _k1_scratch(k) if bf16 and cos is not None else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.rope_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
            None if cos is None else cos.data_ptr(), None if sin is None else sin.data_ptr(),
            lengths.data_ptr(), None if lse is None else lse.data_ptr(),
            None if kscratch is None else kscratch.data_ptr(),
            b, t, h, d, q_mul, int(bf16), stream,
        )
    if err != 0:
        msg = lib.rope_attention_error_string(err).decode()
        raise RuntimeError(f"rope_attention_fwd launch failed: {msg} (cudaError {err})")
    if kscratch is not None:
        LAUNCHES["rope_attention_rotate_k"] += 1


def cross_attention_reference(q, k, v, k_lengths, scale) -> torch.Tensor:
    """Plain PyTorch version of :func:`cross_attention`, all math in fp32:
    (B, Tq, H, d) queries over (B, Tk, H, d) keys and values, each row's
    keys below ``k_lengths[b]``. Returns (B, Tq, H, d) in q's dtype."""
    out, _ = _softmax_attention(q.float(), k.float(), v, k_lengths, scale, False)
    return out.to(q.dtype)


def cross_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_lengths: torch.Tensor,
    scale: float,
    *,
    out: "torch.Tensor | None" = None,
    plain: bool = False,
) -> torch.Tensor:
    """Attention of (B, Tq, H, d) queries over (B, Tk, H, d) keys and values
    of another sequence (Tq and Tk independent), without RoPE: query row t
    of batch row b attends keys ``0 .. k_lengths[b] - 1``; k_lengths (B,)
    int32, each in 1 .. Tk (not read back to check). q, k, v and ``out``
    are read and written by stride, under :func:`rope_flash_attention`'s
    rules. Returns (B, Tq, H, d) in q's dtype: ``out`` when given, else a
    new tensor. On a CPU tensor, or with ``plain``, the plain version
    :func:`cross_attention_reference`; on a CUDA tensor K1's key loop over
    the keys' own sequence (bf16 only; no gradient)."""
    if plain or q.device.type == "cpu":
        res = cross_attention_reference(q, k, v, k_lengths, scale)
        return res if out is None else out.copy_(res)
    if q.device.type != "cuda":
        raise ValueError(f"no cross attention kernel for device {q.device}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the cross attention kernel takes bf16, got {q.dtype}")
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if k.shape != (b, tk, h, d) or v.shape != k.shape:
        raise ValueError(f"k and v must be (B, Tk, H, d) with q's B, H and d; got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    _check_views(q, q, q, out)
    _check_views(k, k, v)
    if k.device != q.device:
        raise ValueError(f"k is on {k.device}, q on {q.device}")
    if k_lengths.dtype != torch.int32 or tuple(k_lengths.shape) != (b,):
        raise ValueError(f"k_lengths must be int32 ({b},), got {k_lengths.dtype} {tuple(k_lengths.shape)}")
    _check_operand("k_lengths", k_lengths, q.device)
    if out is None:
        out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lib = _lib("rope_attention")
    strides = [st for x in (q, k, v, out) for st in _bth_strides(x)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.cross_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
                                      k_lengths.data_ptr(), b, tq, tk, h, d, scale * LOG2_E, stream)
    if err != 0:
        msg = lib.rope_attention_error_string(err).decode()
        raise RuntimeError(f"cross_attention_fwd launch failed: {msg} (cudaError {err})")
    LAUNCHES["cross_attention"] += 1
    return out


def _check_bwd_args(qkv, g, out, lse, num_heads) -> None:
    b, t, w = qkv.shape
    for name, x, shape, dtype in (
        ("g", g, (b, t, w // 3), qkv.dtype),
        ("out", out, (b, t, w // 3), qkv.dtype),
        ("lse", lse, (b, t, num_heads), torch.float32),
    ):
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got {x.dtype} {tuple(x.shape)}")
        _check_operand(name, x, qkv.device)


def rope_attention_fwd(
    qkv: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    lengths: torch.Tensor,
    scale: float,
    num_heads: int,
    *,
    with_lse: bool = False,
    check_lengths: bool = True,
    plain: bool = False,
):
    """K1's wrapper: the forward, no autograd. Returns ``out`` (B, T, C), or
    ``(out, lse2)`` with ``with_lse``. On a CPU tensor, or with ``plain``,
    the plain version; on a CUDA tensor the kernel."""
    if plain or qkv.device.type == "cpu":
        return rope_attention_reference(qkv, cos, sin, lengths, scale, num_heads, with_lse=with_lse)
    if qkv.device.type != "cuda":
        raise ValueError(f"no rope attention kernel for device {qkv.device}")
    qkv = _flat_qkv(qkv)
    d = _check_cuda_args(qkv, cos, sin, lengths, num_heads, check_lengths)
    b, t, w = qkv.shape
    out = torch.empty((b, t, w // 3), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, t, num_heads), dtype=torch.float32, device=qkv.device) if with_lse else None
    q, k, v = qkv.view(b, t, 3, num_heads, d).unbind(2)  # views: K1 reads them by stride
    _k1_launch(q, k, v, out.view(b, t, num_heads, d), cos, sin, lengths, scale * LOG2_E, lse)
    LAUNCHES["rope_attention_fwd"] += 1
    return (out, lse) if with_lse else out


def rope_attention_bwd(
    qkv: torch.Tensor,
    g: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    lengths: torch.Tensor,
    scale: float,
    num_heads: int,
    *,
    plain: bool = False,
) -> torch.Tensor:
    """K2's wrapper: dqkv (B, T, 3C) in qkv's dtype. ``g`` is made
    contiguous and cast to qkv's dtype first. On a CPU tensor, or with
    ``plain``, the plain version; on a CUDA tensor the kernel (three
    launches: a prologue, then dk/dv, then dq; counted as one call)."""
    if plain or qkv.device.type == "cpu":
        return rope_attention_backward_reference(qkv, g, out, lse, cos, sin, lengths, scale, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"no rope attention kernel for device {qkv.device}")
    qkv = _flat_qkv(qkv)
    _check_cuda_args(qkv, cos, sin, lengths, num_heads, check_lengths=False)
    g = g.to(qkv.dtype).contiguous()
    _check_bwd_args(qkv, g, out, lse, num_heads)
    dqkv = torch.empty_like(qkv)
    _k2_launch(qkv, g, out, lse, cos, sin, lengths, scale, num_heads, dqkv, *_k2_scratch(qkv, num_heads))
    LAUNCHES["rope_attention_bwd"] += 1
    return dqkv


def _k2_scratch(qkv: torch.Tensor, num_heads: int) -> "tuple[torch.Tensor, torch.Tensor]":
    """K2's scratch for a (B, T, 3C) projection: ``rot`` (2, B, H, T, d) in
    qkv's dtype (the rotated q * scale * log2(e), then the rotated k; fp32
    at the B/2 micro-batch, 64 x 256 x 12 x 64, is 100.7 MB) and ``stats``
    (2, B, H, T rounded up to 64) fp32 (lse2, then delta, head by head)."""
    b, t, w = qkv.shape
    d = w // 3 // num_heads
    t_pad = -(-t // 64) * 64
    rot = torch.empty((2, b, num_heads, t, d), dtype=qkv.dtype, device=qkv.device)
    stats = torch.empty((2, b, num_heads, t_pad), dtype=torch.float32, device=qkv.device)
    return rot, stats


def _k2_launch(qkv, g, out, lse, cos, sin, lengths, scale, num_heads, dqkv, rot, stats, passes=7) -> None:
    """Launches K2 on operands the caller has checked, writing ``dqkv`` and
    the scratch of :func:`_k2_scratch`. ``passes`` picks the launches (1:
    prologue, 2: dk/dv, 4: dq; 7 all), so that one pass can be
    timed alone after a whole call has filled the scratch. Raises if a
    launch fails; counts nothing."""
    b, t, w = qkv.shape
    lib = _lib("rope_attention_bwd")
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.rope_attention_bwd(
            qkv.data_ptr(), g.data_ptr(), out.data_ptr(), lse.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            lengths.data_ptr(), dqkv.data_ptr(), rot.data_ptr(), stats.data_ptr(),
            b, t, num_heads, w // 3 // num_heads, scale, int(qkv.dtype == torch.bfloat16), passes, stream,
        )
    if err != 0:
        msg = lib.rope_attention_bwd_error_string(err).decode()
        raise RuntimeError(f"rope_attention_bwd launch failed: {msg} (cudaError {err})")


class _RopeAttention(torch.autograd.Function):
    """K1 with lse forward, K2 backward; cos, sin and lengths get no gradient."""

    @staticmethod
    def forward(ctx, qkv, cos, sin, lengths, scale, num_heads, check_lengths, plain):
        out, lse = rope_attention_fwd(
            qkv, cos, sin, lengths, scale, num_heads,
            with_lse=True, check_lengths=check_lengths, plain=plain,
        )
        ctx.save_for_backward(qkv, cos, sin, lengths, out, lse)
        ctx.scale, ctx.num_heads, ctx.plain = scale, num_heads, plain
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        qkv, cos, sin, lengths, out, lse = ctx.saved_tensors
        dqkv = rope_attention_bwd(
            qkv, g, out, lse, cos, sin, lengths, ctx.scale, ctx.num_heads, plain=ctx.plain
        )
        return dqkv, None, None, None, None, None, None, None


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
    qkv's dtype, differentiable in qkv.

    ``check_lengths=False`` skips the lengths check, which reads the tensor
    back to the host; a caller that has already checked them passes it.
    ``plain=True`` runs the plain versions on any device.
    """
    qkv = _flat_qkv(qkv)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _RopeAttention.apply(qkv, cos, sin, lengths, scale, num_heads, check_lengths, plain)
    return rope_attention_fwd(
        qkv, cos, sin, lengths, scale, num_heads, check_lengths=check_lengths, plain=plain
    )


def rope_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    lengths: torch.Tensor,
    scale: float,
    *,
    out: "torch.Tensor | None" = None,
    plain: bool = False,
) -> torch.Tensor:
    """Fused RoPE + masked attention on (B, T, H, d) operands, the
    counterpart of ``fit_tpu``'s ``rope_flash_attention``.

    q, k, v: (B, T, H, d), possibly strided views (for instance of a (B, T,
    3, H, d) projection): K1 reads them by stride, with no copy. cos/sin:
    (B, T, d) fp32 pair-duplicated tables; lengths: (B,) int32 prefix
    lengths, each at least 1 (not read back to check). Returns (B, T, H, d)
    in q's dtype: ``out`` when given, a (B, T, H, d) view that K1 writes by
    stride as it reads q (for instance columns of a wider buffer), else a
    new tensor. On a CPU tensor, or with ``plain``, the plain version
    :func:`rope_flash_reference`; on a CUDA tensor K1.

    Differentiable in q, k and v: when a gradient is wanted they are
    stacked into one packed (B, T, 3C) tensor (one copy) that goes through
    :func:`qkv_rope_attention`'s autograd Function, K1 with lse then K2,
    counted as that entry's launches. A K2 on strided operands is later work.
    """
    b, t, h, d = q.shape
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        qkv = torch.stack([q, k, v], dim=2).reshape(b, t, 3 * h * d)
        res = _RopeAttention.apply(qkv, cos, sin, lengths, scale, h, False, plain).view(b, t, h, d)
        return res if out is None else out.copy_(res)
    if plain or q.device.type == "cpu":
        res = rope_flash_reference(q, k, v, cos, sin, lengths, scale)
        return res if out is None else out.copy_(res)
    if q.device.type != "cuda":
        raise ValueError(f"no rope attention kernel for device {q.device}")
    _check_views(q, k, v, out)
    _check_tables(cos, sin, lengths, b, t, d, q.device)
    if out is None:
        out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    _k1_launch(q, k, v, out, cos, sin, lengths, scale * LOG2_E)
    LAUNCHES["rope_flash_attention"] += 1
    return out


# source -> its C entries, each with its argument kinds: pointer, int64, int, float
_ENTRIES = {
    "rope_attention": {
        # q, k, v, out, their (batch, token, head) strides, cos, sin, lengths, lse,
        # kscratch, batch, seq, heads, head_dim, q_mul, is_bf16, stream
        "rope_attention_fwd": "pppp" + "l" * 12 + "ppppp" "iiii" "fip",
        # q, k, v, out, their (batch, token, head) strides, k_lengths, batch, q_seq, k_seq, heads, head_dim,
        # q_mul, stream
        "cross_attention_fwd": "pppp" + "l" * 12 + "p" "iiiii" "fp",
    },
    # qkv, g, out, lse, cos, sin, lengths, dqkv, rot, stats, batch, seq, heads, head_dim, scale,
    # is_bf16, passes, stream
    "rope_attention_bwd": {"rope_attention_bwd": "pppppppppp" "iiii" "fiip"},
}


def _lib(source: str, src_dir=_build.CSRC) -> ctypes.CDLL:
    """The built library of ``<src_dir>/<source>.cu`` (this tree's ``csrc/``
    unless another's is given) with its C entries typed; a library that
    lacks one of them raises ``AttributeError`` here."""
    lib = _build.load(source, src_dir)
    err = getattr(lib, f"{source}_error_string")
    if err.restype is not ctypes.c_char_p:  # typed last, so a library that failed is checked again
        ctype = {"p": ctypes.c_void_p, "l": ctypes.c_int64, "i": ctypes.c_int, "f": ctypes.c_float}
        for name, kinds in _ENTRIES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = [ctype[k] for k in kinds]
            fn.restype = ctypes.c_int
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib
