"""Fused row-wise glue: adaLN (LayerNorm + modulate) and the SwiGLU product.

Counterpart of ``fit_tpu/ops/fused_adaln.py``: :func:`adaln_modulate` and
:func:`swiglu_glue`, each with its ``use_kernel`` switch. ``use_kernel=False``
is the unfused composition of ``fit_tpu_torch.models.layers``;
``use_kernel=True`` is the fused function, computed in fp32 and cast once:
on a CUDA tensor the wrapper launches ``csrc/row_quant.cu`` (its non-quant
variants) or raises, on a CPU tensor (or with ``plain=True``) it runs the
plain PyTorch version beside it. :func:`adaln_residual` (K5R, no ``fit_tpu``
counterpart) is :func:`adaln_modulate` with a FiT block's attention residual
folded in front of it; :func:`swiglu_halves` is K6 on the two halves of one
``[gate | up]`` projection (the sparse-MoE experts' layout), and
:func:`moe_combine` (K7, no ``fit_tpu`` counterpart) the sparse-MoE FFN's
weighted sum of each token's expert rows and its shared expert's row. Their
launches count in ``ops.LAUNCHES`` under "swiglu_glue" and "moe_combine".
FLUX's blocks (``fit_tpu_torch.models.flux``) add two more, neither with a
``fit_tpu`` counterpart: :func:`qk_norm` (K8, FLUX's QK-RMSNorm of each
head of q and k in a ``[q | k | v]`` projection, in place or into another
buffer at a row offset) and :func:`gelu_glue` (K6G, the tanh GELU between
two projections), each reading and writing by row stride; counted under
"qk_norm" and "gelu_glue". Wan's blocks (``fit_tpu_torch.models.wan``) add
:func:`qk_norm_wide` (K8W, the RMSNorm of a whole row of q or k across its
heads, in place; "qk_norm_wide") and run :func:`adaln_modulate` and
:func:`adaln_residual` on an fp32 residual stream with bf16 results
(``out_dtype``).

The float blocks of ``fit_tpu_torch.models.layers`` call these three in a
forward that needs no backward, on the card (``layers.fused_glue``); the
int8 path calls the quantizing variants of the same kernels through
``fit_tpu_torch.ops.quant``, which binds them from here.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from fit_tpu_torch.ops import LAUNCHES, _build

__all__ = [
    "adaln_modulate",
    "adaln_residual",
    "swiglu_glue",
    "swiglu_halves",
    "moe_combine",
    "moe_combine_reference",
    "qk_norm",
    "qk_norm_wide",
    "gelu_glue",
    "adaln_reference",
    "adaln_residual_reference",
    "swiglu_reference",
    "qk_norm_reference",
    "qk_norm_wide_reference",
    "gelu_reference",
]


def adaln_reference(x, shift, scale, eps: float = 1e-6, out_dtype=None) -> torch.Tensor:
    """Plain version of ``_adaln_kernel``: fp32 LayerNorm and modulate,
    cast once to ``out_dtype`` (x's dtype when None). x (B, T, D); shift,
    scale (B, D)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    h = normed * (1.0 + scale.float()[:, None, :]) + shift.float()[:, None, :]
    return h.to(out_dtype or x.dtype)


def adaln_residual_reference(x, y, gate, shift, scale, eps: float = 1e-6,
                             out_dtype=None) -> "tuple[torch.Tensor, torch.Tensor]":
    """Plain version of K5R: the attention residual ``x + gate * y`` as the
    unfused block computes it (the product rounded to x's dtype, then the
    sum; a bf16 y on an fp32 x is promoted), and :func:`adaln_reference` of
    that. x, y (B, T, D); gate, shift, scale (B, D). Returns ``(x_new,
    h)``, x_new in x's dtype."""
    x_new = x + gate[:, None, :] * y
    return x_new, adaln_reference(x_new, shift, scale, eps, out_dtype)


def swiglu_reference(gate, value) -> torch.Tensor:
    """Plain version of ``_swiglu_kernel``: ``silu(gate) * value`` in fp32,
    cast once to gate's dtype."""
    return (F.silu(gate.float()) * value.float()).to(gate.dtype)


def adaln_modulate(
    x: torch.Tensor,
    shift: torch.Tensor,
    scale: torch.Tensor,
    *,
    eps: float = 1e-6,
    use_kernel: bool = True,
    plain: bool = False,
    out_dtype: "torch.dtype | None" = None,
) -> torch.Tensor:
    """``LN(x) * (1 + scale) + shift`` with affine-free fp32 LayerNorm.
    x: (B, T, D); shift/scale: (B, D). Returns (B, T, D) in x's dtype, or
    in ``out_dtype``: bf16 from an fp32 x (and fp32 shift and scale) is
    the one mixed case the kernel takes."""
    if not use_kernel:
        from fit_tpu_torch.models.layers import layer_norm_fp32, modulate

        return modulate(layer_norm_fp32(x, eps), shift, scale)
    if plain or x.device.type == "cpu":
        return adaln_reference(x, shift, scale, eps, out_dtype)
    if out_dtype not in (None, x.dtype):
        out = launch_adaln_mixed(x, shift, scale, eps, out_dtype)
    else:
        out, _ = launch_adaln(x, shift, scale, eps, quant=False)
    LAUNCHES["adaln_modulate"] += 1
    return out


def adaln_residual(
    x: torch.Tensor,
    y: torch.Tensor,
    gate: torch.Tensor,
    shift: torch.Tensor,
    scale: torch.Tensor,
    *,
    eps: float = 1e-6,
    plain: bool = False,
    out_dtype: "torch.dtype | None" = None,
) -> "tuple[torch.Tensor, torch.Tensor]":
    """A FiT block's attention residual and the FFN's adaLN in one pass:
    ``x_new = x + gate * y``, with the unfused block's roundings, and
    ``LN(x_new) * (1 + scale) + shift``. x, y: (B, T, D); gate, shift,
    scale: (B, D). Returns ``(x_new, h)``, both (B, T, D) in x's dtype; or
    on an fp32 residual stream (x, gate, shift, scale fp32) with a bf16
    branch ``y``, x_new fp32 and h in ``out_dtype`` (bf16), Wan's blocks'
    mixed case."""
    if plain or x.device.type == "cpu":
        return adaln_residual_reference(x, y, gate, shift, scale, eps, out_dtype)
    if out_dtype not in (None, x.dtype) or y.dtype != x.dtype:
        out = launch_adaln_residual_mixed(x, y, gate, shift, scale, eps, out_dtype or x.dtype)
    else:
        out = launch_adaln_residual(x, y, gate, shift, scale, eps)
    LAUNCHES["adaln_residual"] += 1
    return out


def swiglu_glue(
    gate: torch.Tensor, value: torch.Tensor, *, use_kernel: bool = True, plain: bool = False
) -> torch.Tensor:
    """``silu(gate) * value``, the SwiGLU stage between fc1 and fc2.
    gate, value: (B, T, H). Returns (B, T, H) in gate's dtype."""
    if not use_kernel:
        return F.silu(gate) * value
    if plain or gate.device.type == "cpu":
        return swiglu_reference(gate, value)
    out, _ = launch_silu_mul(gate, value, quant=False)
    LAUNCHES["swiglu_glue"] += 1
    return out


def swiglu_halves(gate_up: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """``silu(gate) * up`` of a (..., 2H) ``[gate | up]`` projection: K6
    reading both halves of each row in place (no copy of either). Returns
    (..., H) in gate_up's dtype; the plain version is :func:`swiglu_reference`
    of the two halves."""
    h = gate_up.shape[-1] // 2
    if plain or gate_up.device.type == "cpu":
        return swiglu_reference(gate_up[..., :h], gate_up[..., h:])
    out = launch_swiglu_halves(gate_up)
    LAUNCHES["swiglu_glue"] += 1
    return out


def moe_combine_reference(ys, pos, w, shared) -> torch.Tensor:
    """Plain version of K7: ``sum_j w[:, j] * ys[pos[:, j]]`` in fp32 (each
    product rounded, then the sum over the slots), plus ``shared`` in fp32,
    cast once to ys's dtype. ys (M, D); pos (N, k) int64; w (N, k) fp32;
    shared (N, D). Returns (N, D)."""
    n, k = pos.shape
    acc = (ys.index_select(0, pos.reshape(-1)).view(n, k, -1).float() * w[..., None]).sum(dim=1)
    return (acc + shared.float()).to(ys.dtype)


def moe_combine(ys, pos, w, shared, *, plain: bool = False) -> torch.Tensor:
    """The sparse-MoE FFN's output rows: each token's k expert rows of ``ys``
    (at ``pos``) weighted by ``w``, plus its shared expert's row, in fp32 and
    cast once (:func:`moe_combine_reference`). K7 on the card, one pass that
    reads each input row once; the plain version on the CPU or with
    ``plain=True``."""
    if plain or ys.device.type == "cpu":
        return moe_combine_reference(ys, pos, w, shared)
    out = launch_moe_combine(ys, pos, w, shared)
    LAUNCHES["moe_combine"] += 1
    return out


def qk_norm_reference(x, scale, num_heads: int, eps: float = 1e-6) -> torch.Tensor:
    """Plain version of K8 on one of q or k: each head's ``d`` lanes of x
    (..., H d) times ``rsqrt(mean(x^2) + eps)`` and the learned ``scale``
    (d,), in fp32, cast once to x's dtype. (FLUX's ``RMSNorm`` casts before
    the scale's multiply; one cast after it is a departure inside the
    dtype's rounding.)"""
    xf = x.float().reshape(*x.shape[:-1], num_heads, -1)
    normed = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps) * scale.float()
    return normed.reshape(x.shape).to(x.dtype)


def qk_norm_wide_reference(x, weight, eps: float = 1e-6) -> torch.Tensor:
    """Plain version of K8W: Wan's RMSNorm of a whole row of q or k (all
    its heads' lanes), ``rsqrt(mean(x^2) + eps)`` in fp32, cast to x's
    dtype (the released ``type_as``), times the learned ``weight`` (D,) in
    fp32, cast again. x (..., D)."""
    xf = x.float()
    normed = (xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)).to(x.dtype)
    return (normed.float() * weight.float()).to(x.dtype)


def qk_norm_wide(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6, plain: bool = False) -> torch.Tensor:
    """Wan's QK-RMSNorm (``WanRMSNorm``) of each (B, T, D) row of q or k
    over all D lanes (across heads, not head by head), in place, x read and
    written by row stride (a view of a wider projection is fine): K8W on
    the card, :func:`qk_norm_wide_reference` on the CPU or with
    ``plain=True``. ``weight`` (D,) in x's dtype. Returns ``x``."""
    if plain or x.device.type == "cpu":
        x.copy_(qk_norm_wide_reference(x, weight, eps))
        return x
    _check_strided("x", x, x)
    d = x.shape[-1]
    if d > _MAX_WIDTH:
        raise ValueError(f"K8W takes a width of at most {_MAX_WIDTH}, got {d}")
    if (weight.shape != (d,) or weight.dtype != x.dtype or weight.device != x.device or not weight.is_contiguous()
            or weight.data_ptr() % 16):
        raise ValueError(f"weight must be a contiguous, aligned ({d},) {x.dtype} on {x.device}")
    b, t = x.shape[:2]
    if b * t:
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _lib().qk_rms_wide_fwd(x.data_ptr(), *_row_strides(x), weight.data_ptr(), b, t, d, eps,
                                         int(x.dtype == torch.bfloat16), stream)
        _raise_on(err, "qk_rms_wide_rows")
    LAUNCHES["qk_norm_wide"] += 1
    return x


def gelu_reference(x) -> torch.Tensor:
    """Plain version of K6G: the tanh GELU in fp32, cast once to x's dtype."""
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


def qk_norm(
    qkv: torch.Tensor,
    q_scale: torch.Tensor,
    k_scale: torch.Tensor,
    num_heads: int,
    *,
    out: "torch.Tensor | None" = None,
    row_offset: int = 0,
    eps: float = 1e-6,
    plain: bool = False,
) -> torch.Tensor:
    """FLUX's QKNorm on a (B, T, W) projection whose first 3C columns are
    ``[q | k | v]`` (C = ``num_heads * d``, ``d`` = ``q_scale``'s length),
    read by row stride: each head of q and of k RMS-normed and scaled
    (:func:`qk_norm_reference`). With ``out`` None, in place: q and k are
    overwritten and v left as it is; returns ``qkv``. With ``out`` (B, T',
    3C), rows ``row_offset .. row_offset + T`` of it receive the normed q and
    k and a copy of v (the double block's joint ``[txt | img]`` buffer);
    returns ``out``. K8 on the card, the plain version on the CPU or with
    ``plain=True``."""
    b, t = qkv.shape[:2]
    c = q_scale.shape[0] * num_heads
    dst = qkv if out is None else out[:, row_offset : row_offset + t]
    if plain or qkv.device.type == "cpu":
        q, k = (qk_norm_reference(x, s, num_heads, eps) for x, s in ((qkv[..., :c], q_scale), (qkv[..., c : 2 * c], k_scale)))
        dst[..., :c] = q
        dst[..., c : 2 * c] = k
        if out is not None:
            dst[..., 2 * c : 3 * c] = qkv[..., 2 * c : 3 * c]
        return qkv if out is None else out
    launch_qk_norm(qkv, q_scale, k_scale, num_heads, dst, eps, copy_v=out is not None)
    LAUNCHES["qk_norm"] += 1
    return qkv if out is None else out


def gelu_glue(x: torch.Tensor, *, out: "torch.Tensor | None" = None, plain: bool = False) -> torch.Tensor:
    """``gelu_tanh(x)`` of a (B, T, W) x read by row stride, into ``out``
    (B, T, W), written by row stride (a new contiguous tensor when None):
    K6G on the card, :func:`gelu_reference` on the CPU or with
    ``plain=True``. Returns ``out``."""
    if out is None:
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if plain or x.device.type == "cpu":
        out.copy_(gelu_reference(x))
        return out
    launch_gelu(x, out)
    LAUNCHES["gelu_glue"] += 1
    return out


# --- the CUDA kernels of csrc/row_quant.cu --------------------------------

_MAX_WIDTH = 8192  # 128 threads x 8 chunks of 8 elements (K3 takes a warp per row up to 1152)


def _check_rows(name: str, t: torch.Tensor, ref: torch.Tensor) -> None:
    if t.device != ref.device:
        raise ValueError(f"{name} is on {t.device}, expected {ref.device}")
    if t.dtype != ref.dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {ref.dtype} like the first input")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (the kernel moves 16-byte vectors)")


def _check_first(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no row kernel for device {t.device}")
    if t.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name} must be bf16 or fp32, got {t.dtype}")
    if t.dim() != 3:
        raise ValueError(f"{name} must be (B, T, width), got {tuple(t.shape)}")
    width = t.shape[-1]
    if width % 8 or width > _MAX_WIDTH:
        raise ValueError(f"the row kernels take a width that is a multiple of 8, at most {_MAX_WIDTH}; got {width}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (the kernel moves 16-byte vectors)")


def _outputs(x: torch.Tensor, quant: bool):
    rows = x.shape[0] * x.shape[1]
    if quant:
        out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
        row_scale = torch.empty((*x.shape[:2], 1), dtype=torch.float32, device=x.device)
    else:
        out = torch.empty_like(x)
        row_scale = None
    return rows, out, row_scale


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().row_quant_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cudaError {err})")


def _check_conditioning(x, **conds) -> None:
    """Each (B, D) conditioning row tensor (shift, scale, gate: chunks of an
    adaLN output) as the kernels read it."""
    b, _, d = x.shape
    for name, cond in conds.items():
        _check_rows(name, cond, x)
        if cond.dim() != 2 or tuple(cond.shape) != (b, d) or cond.stride(1) != 1 or cond.stride(0) % 8:
            raise ValueError(
                f"{name} must be ({b}, {d}) with unit column stride and a row stride that is a "
                f"multiple of 8, got {tuple(cond.shape)} strides {cond.stride()}"
            )
    if len({cond.stride(0) for cond in conds.values()}) > 1:
        raise ValueError(f"{' and '.join(conds)} must share a row stride")


def launch_adaln(x, shift, scale, eps: float, *, quant: bool):
    """Launch ``adaln_rows<quant>`` on x's current stream. Returns
    ``(out, row_scale)``: out in x's dtype and row_scale None, or int8 codes
    and (B, T, 1) fp32 scales. Raises on what the kernel does not take."""
    _check_first("x", x)
    _check_conditioning(x, shift=shift, scale=scale)
    b, t, d = x.shape
    rows, out, row_scale = _outputs(x, quant)
    if rows == 0:
        return out, row_scale
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().adaln_rows_fwd(
            x.data_ptr(), shift.data_ptr(), scale.data_ptr(), shift.stride(0), out.data_ptr(),
            row_scale.data_ptr() if quant else None, rows, t, d, eps,
            int(x.dtype == torch.bfloat16), int(quant), stream,
        )
    _raise_on(err, "adaln_rows")
    return out, row_scale


def launch_adaln_residual(x, y, gate, shift, scale, eps: float):
    """Launch K5R on x's current stream. Returns ``(x_new, h)`` in x's
    dtype. Raises on what the kernel does not take."""
    _check_first("x", x)
    _check_first("y", y)
    if y.shape != x.shape:
        raise ValueError(f"y {tuple(y.shape)} != x {tuple(x.shape)}")
    _check_rows("y", y, x)
    _check_conditioning(x, gate=gate, shift=shift, scale=scale)
    b, t, d = x.shape
    x_new, out = torch.empty_like(x), torch.empty_like(x)
    if b * t == 0:
        return x_new, out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().adaln_resid_rows_fwd(
            x.data_ptr(), y.data_ptr(), gate.data_ptr(), shift.data_ptr(), scale.data_ptr(), shift.stride(0),
            x_new.data_ptr(), out.data_ptr(), b * t, t, d, eps, int(x.dtype == torch.bfloat16), stream,
        )
    _raise_on(err, "adaln_resid_rows")
    return x_new, out


def _check_mixed(x, out_dtype) -> None:
    """The one mixed case of K5 and K5R: an fp32 x (the conditioning rows
    are checked to share its dtype) with a bf16 result."""
    if x.dtype != torch.float32 or out_dtype != torch.bfloat16:
        raise TypeError(f"the mixed row kernels take an fp32 x and give bf16, got {x.dtype} -> {out_dtype}")


def launch_adaln_mixed(x, shift, scale, eps: float, out_dtype):
    """Launch K5 on an fp32 x with a bf16 result. Raises on what the kernel
    does not take."""
    _check_first("x", x)
    _check_mixed(x, out_dtype)
    _check_conditioning(x, shift=shift, scale=scale)
    b, t, d = x.shape
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if b * t:
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _lib().adaln_rows_mixed_fwd(x.data_ptr(), shift.data_ptr(), scale.data_ptr(), shift.stride(0),
                                              out.data_ptr(), b * t, t, d, eps, stream)
        _raise_on(err, "adaln_rows_mixed")
    return out


def launch_adaln_residual_mixed(x, y, gate, shift, scale, eps: float, out_dtype):
    """Launch K5R on an fp32 x with a bf16 branch y: ``(x_new, h)``, x_new
    fp32 and h bf16. Raises on what the kernel does not take."""
    _check_first("x", x)
    _check_first("y", y)
    _check_mixed(x, out_dtype)
    if y.shape != x.shape or y.dtype != torch.bfloat16 or y.device != x.device:
        raise ValueError(f"y must be bf16 {tuple(x.shape)} on {x.device}, got {y.dtype} {tuple(y.shape)}")
    _check_conditioning(x, gate=gate, shift=shift, scale=scale)
    b, t, d = x.shape
    x_new, out = torch.empty_like(x), torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if b * t:
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _lib().adaln_resid_rows_mixed_fwd(
                x.data_ptr(), y.data_ptr(), gate.data_ptr(), shift.data_ptr(), scale.data_ptr(), shift.stride(0),
                x_new.data_ptr(), out.data_ptr(), b * t, t, d, eps, stream)
        _raise_on(err, "adaln_resid_rows_mixed")
    return x_new, out


def launch_silu_mul(gate, value, *, quant: bool):
    """Launch ``silu_mul_rows<quant>``; returns ``(out, row_scale)`` as
    :func:`launch_adaln` does."""
    _check_first("gate", gate)
    _check_first("value", value)
    if value.shape != gate.shape:
        raise ValueError(f"value {tuple(value.shape)} != gate {tuple(gate.shape)}")
    _check_rows("value", value, gate)
    rows, out, row_scale = _outputs(gate, quant)
    if rows == 0:
        return out, row_scale
    with torch.cuda.device(gate.device):
        stream = torch.cuda.current_stream(gate.device).cuda_stream
        err = _lib().silu_mul_rows_fwd(
            gate.data_ptr(), value.data_ptr(), out.data_ptr(),
            row_scale.data_ptr() if quant else None, rows, gate.shape[-1],
            int(gate.dtype == torch.bfloat16), int(quant), stream,
        )
    _raise_on(err, "silu_mul_rows")
    return out, row_scale


def launch_swiglu_halves(gate_up):
    """Launch K6 on the halves of a contiguous (..., 2H) ``[gate | up]``
    tensor; returns (..., H). Raises on what the kernel does not take."""
    if gate_up.device.type != "cuda":
        raise ValueError(f"no row kernel for device {gate_up.device}")
    if gate_up.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"gate_up must be bf16 or fp32, got {gate_up.dtype}")
    width = gate_up.shape[-1] // 2
    if gate_up.shape[-1] % 2 or width % 8 or width > _MAX_WIDTH:
        raise ValueError(f"each half of gate_up must be a multiple of 8 wide, at most {_MAX_WIDTH}; "
                         f"got {tuple(gate_up.shape)}")
    if not gate_up.is_contiguous():
        raise ValueError("gate_up must be contiguous")
    if gate_up.data_ptr() % 16:
        raise ValueError("gate_up must start on a 16-byte boundary (the kernel moves 16-byte vectors)")
    out = torch.empty((*gate_up.shape[:-1], width), dtype=gate_up.dtype, device=gate_up.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(gate_up.device):
        stream = torch.cuda.current_stream(gate_up.device).cuda_stream
        err = _lib().swiglu_halves_fwd(
            gate_up.data_ptr(), out.data_ptr(), out.numel() // width, width, int(gate_up.dtype == torch.bfloat16),
            stream,
        )
    _raise_on(err, "swiglu_halves")
    return out


def launch_moe_combine(ys, pos, w, shared):
    """Launch K7; returns (N, D) in ys's dtype. Raises on what the kernel
    does not take."""
    _check_first("ys", ys[None])
    n, k = pos.shape
    if pos.dtype != torch.int64 or w.dtype != torch.float32 or tuple(w.shape) != (n, k):
        raise TypeError(f"pos must be (N, k) int64 and w (N, k) fp32, got {pos.dtype} {tuple(pos.shape)} and "
                        f"{w.dtype} {tuple(w.shape)}")
    for name, t in (("pos", pos), ("w", w)):
        if t.device != ys.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {ys.device}")
    _check_rows("shared", shared, ys)
    if tuple(shared.shape) != (n, ys.shape[1]) or not shared.is_contiguous():
        raise ValueError(f"shared must be a contiguous ({n}, {ys.shape[1]}), got {tuple(shared.shape)}")
    out = torch.empty((n, ys.shape[1]), dtype=ys.dtype, device=ys.device)
    if n == 0:
        return out
    with torch.cuda.device(ys.device):
        stream = torch.cuda.current_stream(ys.device).cuda_stream
        err = _lib().moe_combine_fwd(
            ys.data_ptr(), pos.data_ptr(), w.data_ptr(), shared.data_ptr(), out.data_ptr(),
            n, k, ys.shape[1], int(ys.dtype == torch.bfloat16), stream,
        )
    _raise_on(err, "moe_combine")
    return out


def _check_strided(name: str, t: torch.Tensor, ref: torch.Tensor) -> None:
    """A (B, T, width) operand read or written by (batch, token) strides:
    ref's dtype and device, a contiguous last dim, strides and base that
    keep every 8-element chunk a 16-byte vector."""
    if t.device.type != "cuda" or t.device != ref.device:
        raise ValueError(f"{name} is on {t.device}, expected the card {ref.device}")
    if t.dtype not in (torch.bfloat16, torch.float32) or t.dtype != ref.dtype:
        raise TypeError(f"{name} must be bf16 or fp32 like the source, got {t.dtype}")
    if t.dim() != 3 or t.shape[-1] % 8:
        raise ValueError(f"{name} must be (B, T, width) with a width that is a multiple of 8, got {tuple(t.shape)}")
    if t.stride(-1) != 1 or any(st % 8 for n, st in zip(t.shape[:2], t.stride()[:2]) if n > 1):
        raise ValueError(f"{name} needs a contiguous last dim and batch and token strides that are multiples of 8, "
                         f"got strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (the kernel moves 16-byte vectors)")


def _row_strides(t: torch.Tensor) -> "tuple[int, int]":
    return tuple(st if n > 1 else 0 for n, st in zip(t.shape[:2], t.stride()[:2]))


def launch_qk_norm(qkv, q_scale, k_scale, num_heads: int, dst, eps: float, *, copy_v: bool) -> None:
    """Launch K8 from ``qkv`` into ``dst`` (the same rows of qkv itself
    when not ``copy_v``). Raises on what the kernel does not take."""
    _check_strided("qkv", qkv, qkv)
    _check_strided("out", dst, qkv)
    d = q_scale.shape[0]
    c = d * num_heads
    if d < 8 or d > 256 or d & (d - 1):
        raise ValueError(f"K8 takes a head dim that is a power of two from 8 to 256, got {d}")
    if qkv.shape[-1] < 3 * c or dst.shape[-1] < 3 * c or dst.shape[:2] != qkv.shape[:2]:
        raise ValueError(f"qkv {tuple(qkv.shape)} and its destination {tuple(dst.shape)} must hold 3 x {c} columns "
                         "over the same rows")
    for name, s in (("q_scale", q_scale), ("k_scale", k_scale)):
        if s.shape != (d,) or s.dtype != qkv.dtype or s.device != qkv.device or not s.is_contiguous() or s.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, aligned ({d},) {qkv.dtype} on {qkv.device}")
    b, t = qkv.shape[:2]
    if b * t == 0:
        return
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = _lib().qk_rms_rows_fwd(
            qkv.data_ptr(), *_row_strides(qkv), dst.data_ptr(), *_row_strides(dst), q_scale.data_ptr(),
            k_scale.data_ptr(), b, t, num_heads, d, eps, int(copy_v), int(qkv.dtype == torch.bfloat16), stream,
        )
    _raise_on(err, "qk_rms_rows")


def launch_gelu(x, out) -> None:
    """Launch K6G from ``x`` into ``out``. Raises on what the kernel does
    not take."""
    _check_strided("x", x, x)
    _check_strided("out", out, x)
    if out.shape != x.shape:
        raise ValueError(f"out {tuple(out.shape)} != x {tuple(x.shape)}")
    b, t, w = x.shape
    if b * t * w == 0:
        return
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().gelu_rows_fwd(
            x.data_ptr(), *_row_strides(x), out.data_ptr(), *_row_strides(out), b, t, w,
            int(x.dtype == torch.bfloat16), stream,
        )
    _raise_on(err, "gelu_rows")


def _lib() -> ctypes.CDLL:
    return bind(_build.load("row_quant"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built ``row_quant.cu`` on ``lib``."""
    if lib.adaln_rows_fwd.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.adaln_rows_fwd.argtypes = [
            ptr, ptr, ptr, i64, ptr, ptr, i32, i32, i32, ctypes.c_float, i32, i32, ptr,
        ]
        lib.adaln_rows_fwd.restype = i32
        if hasattr(lib, "adaln_resid_rows_fwd"):  # a build of a tree before K5R has none
            lib.adaln_resid_rows_fwd.argtypes = [
                ptr, ptr, ptr, ptr, ptr, i64, ptr, ptr, i32, i32, i32, ctypes.c_float, i32, ptr,
            ]
            lib.adaln_resid_rows_fwd.restype = i32
        lib.silu_mul_rows_fwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
        lib.silu_mul_rows_fwd.restype = i32
        if hasattr(lib, "swiglu_halves_fwd"):  # a build of a tree before them has neither
            lib.swiglu_halves_fwd.argtypes = [ptr, ptr, i32, i32, i32, ptr]
            lib.swiglu_halves_fwd.restype = i32
            lib.moe_combine_fwd.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
            lib.moe_combine_fwd.restype = i32
        if hasattr(lib, "qk_rms_rows_fwd"):  # a build of a tree before FLUX's kernels has neither
            lib.qk_rms_rows_fwd.argtypes = [ptr, i64, i64, ptr, i64, i64, ptr, ptr, i32, i32, i32, i32,
                                            ctypes.c_float, i32, i32, ptr]
            lib.qk_rms_rows_fwd.restype = i32
            lib.gelu_rows_fwd.argtypes = [ptr, i64, i64, ptr, i64, i64, i32, i32, i32, i32, ptr]
            lib.gelu_rows_fwd.restype = i32
        if hasattr(lib, "qk_rms_wide_fwd"):  # a build of a tree before Wan's kernels has none of these
            lib.qk_rms_wide_fwd.argtypes = [ptr, i64, i64, ptr, i32, i32, i32, ctypes.c_float, i32, ptr]
            lib.qk_rms_wide_fwd.restype = i32
            lib.adaln_rows_mixed_fwd.argtypes = [ptr, ptr, ptr, i64, ptr, i32, i32, i32, ctypes.c_float, ptr]
            lib.adaln_rows_mixed_fwd.restype = i32
            lib.adaln_resid_rows_mixed_fwd.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, ptr, ptr, i32, i32, i32,
                                                       ctypes.c_float, ptr]
            lib.adaln_resid_rows_mixed_fwd.restype = i32
        lib.row_quant_error_string.argtypes = [i32]
        lib.row_quant_error_string.restype = ctypes.c_char_p
    return lib
