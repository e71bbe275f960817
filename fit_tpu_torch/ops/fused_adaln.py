"""Fused row-wise glue: adaLN (LayerNorm + modulate) and the SwiGLU product.

Counterpart of ``fit_tpu/ops/fused_adaln.py``: :func:`adaln_modulate` and
:func:`swiglu_glue`, each with its ``use_kernel`` switch. ``use_kernel=False``
is the unfused composition of ``fit_tpu_torch.models.layers``;
``use_kernel=True`` is the fused function, computed in fp32 and cast once:
on a CUDA tensor the wrapper launches ``csrc/row_quant.cu`` (its non-quant
variants) or raises, on a CPU tensor (or with ``plain=True``) it runs the
plain PyTorch version beside it. Like ``fit_tpu``, the model does not call
these two; the int8 path calls the quantizing variants of the same kernels
through ``fit_tpu_torch.ops.quant``, which binds them from here.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from fit_tpu_torch.ops import LAUNCHES, _build

__all__ = [
    "adaln_modulate",
    "swiglu_glue",
    "adaln_reference",
    "swiglu_reference",
    "launches",
    "reset_launches",
]

# Kernel launches of each wrapper since the last reset_launches(), read as
# the dict ``launches``: the ops package's LAUNCHES of these names.
_KERNELS = ("adaln_modulate", "swiglu_glue")


def reset_launches() -> None:
    for k in _KERNELS:
        LAUNCHES[k] = 0


def __getattr__(name):
    if name == "launches":
        return {k: LAUNCHES[k] for k in _KERNELS}
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def adaln_reference(x, shift, scale, eps: float = 1e-6) -> torch.Tensor:
    """Plain version of ``_adaln_kernel``: fp32 LayerNorm and modulate,
    cast once to x's dtype. x (B, T, D); shift, scale (B, D)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    h = normed * (1.0 + scale.float()[:, None, :]) + shift.float()[:, None, :]
    return h.to(x.dtype)


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
) -> torch.Tensor:
    """``LN(x) * (1 + scale) + shift`` with affine-free fp32 LayerNorm.
    x: (B, T, D); shift/scale: (B, D). Returns (B, T, D) in x's dtype."""
    if not use_kernel:
        from fit_tpu_torch.models.layers import layer_norm_fp32, modulate

        return modulate(layer_norm_fp32(x, eps), shift, scale)
    if plain or x.device.type == "cpu":
        return adaln_reference(x, shift, scale, eps)
    out, _ = launch_adaln(x, shift, scale, eps, quant=False)
    LAUNCHES["adaln_modulate"] += 1
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


def launch_adaln(x, shift, scale, eps: float, *, quant: bool):
    """Launch ``adaln_rows<quant>`` on x's current stream. Returns
    ``(out, row_scale)``: out in x's dtype and row_scale None, or int8 codes
    and (B, T, 1) fp32 scales. Raises on what the kernel does not take."""
    _check_first("x", x)
    b, t, d = x.shape
    for name, cond in (("shift", shift), ("scale", scale)):
        _check_rows(name, cond, x)
        if cond.dim() != 2 or tuple(cond.shape) != (b, d) or cond.stride(1) != 1 or cond.stride(0) % 8:
            raise ValueError(
                f"{name} must be ({b}, {d}) with unit column stride and a row stride that is a "
                f"multiple of 8, got {tuple(cond.shape)} strides {cond.stride()}"
            )
    if shift.stride(0) != scale.stride(0):
        raise ValueError("shift and scale must share a row stride")
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
        lib.silu_mul_rows_fwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
        lib.silu_mul_rows_fwd.restype = i32
        lib.row_quant_error_string.argtypes = [i32]
        lib.row_quant_error_string.restype = ctypes.c_char_p
    return lib
