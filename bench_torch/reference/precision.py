"""How the reference multiplies: fp32, or the fp8 control.

``FP32`` is plain fp32 matmul (the caller turns TF32 off). ``FP8`` is the
control for a configuration stated in bf16: the nearest precision below
it. Each operand of every matmul is rounded to float8 e4m3 with a scale
per row of the activation and per output row of the weight (amax / 448),
the way an fp8 GEMM is fed, and the product is taken in fp32; in a
backward the incoming gradient is rounded to e5m2 the same way.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def fp8_round(x: torch.Tensor, dim: int = -1, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """``x`` rounded through ``dtype`` with one scale per slice along ``dim``."""
    top = E4M3_MAX if dtype == torch.float8_e4m3fn else E5M2_MAX
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = top / amax
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Fp8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xq, wq = fp8_round(x), fp8_round(w)
        ctx.save_for_backward(xq, wq)
        return xq @ wq.t()

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = fp8_round(g, dtype=torch.float8_e5m2)
        gx = gq @ wq
        gw = gq.reshape(-1, gq.shape[-1]).t() @ xq.reshape(-1, xq.shape[-1])
        return gx, gw


class Precision:
    """``linear(x, w, b)`` and ``bmm(a, b)`` in one precision."""

    name = "fp32"

    def linear(self, x, w, b=None):
        y = x @ w.t()
        return y if b is None else y + b

    def matmul(self, a, b):
        return a @ b


class Fp8(Precision):
    name = "fp8"

    def linear(self, x, w, b=None):
        y = _Fp8Linear.apply(x, w)
        return y if b is None else y + b

    def matmul(self, a, b):
        # scores: a (.., q, d) rows and b (.., d, k) columns; weights: p
        # rows. Rounded in the forward, the gradient passes straight through.
        aq = a + (fp8_round(a.detach(), -1) - a.detach())
        bq = b + (fp8_round(b.detach(), -2) - b.detach())
        return aq @ bq


FP32 = Precision()
FP8 = Fp8()
PRECISIONS = {"fp32": FP32, "fp8": FP8}
