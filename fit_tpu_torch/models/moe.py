"""DiT-MoE's sparse mixture-of-experts FFN: a softmax router over E SwiGLU
experts, the top k of them for each token, and a shared SwiGLU expert.

Fei et al., "Scaling Diffusion Transformers to 16 Billion Parameters"
(arXiv:2407.11633; github.com/feizc/DiT-MoE ``SparseMoeBlock``, the
DeepSeekMoE design), for a token row x of width D:

    s = softmax(x W_g^T)                E scores, fp32; the router has no bias
    (idx, w) = top_k(s)                 w is not renormalised (norm_topk_prob False)
    y = sum_k w_k E_{idx_k}(x) + S(x)
    E_e(x) = W_down,e (silu(W_gate,e x) * W_up,e x)     width H, no biases
    S(x)   = the shared experts as one SwiGLU of width shared_hidden, no biases

Inference is dropless: every token reaches its k experts, with no capacity
limit. The load-balance loss is a training term and is not here.
``fit_tpu``'s ``MoeSwiGLU`` is another layer (a top-1 Switch FFN with a
capacity) and is not ported.

Parameters: the router ``gate`` (E, D), kept in fp32 by
``fit_tpu_torch.sampling.cast_for_sampling`` (``fp32_params``); each
expert's ``[gate | up]`` projection stacked as ``w_gate_up`` (E, D, 2H) and
its down projection as ``w_down`` (E, H, D), both laid out (in, out) so
that ``x @ w`` is the projection; the shared expert's ``shared_gate_up``
(D, 2S) and ``shared_down`` (S, D).

Both routes share :func:`route` and :func:`dispatch`: the assignments
(token, slot) sorted by expert, stably, into one row block per expert, and
the int32 ends of the blocks. On the card in bf16 without grad
(:func:`grouped`) the experts are two grouped GEMMs
(``torch._grouped_mm``) over those device offsets with K6 between them
(``ops.fused_adaln.swiglu_halves``), so no count leaves the device: the
forward never waits for the card. Every other forward (the CPU, fp32,
under grad, ``plain=True``) loops over the experts, reading the block ends
on the host, as DiT-MoE's ``moe_infer`` does. Both then combine in fp32,
the shared expert's output added before the one cast: in K7
(``ops.fused_adaln.moe_combine``) where ``layers.fused_glue`` runs the
block's row glue in its kernels, else in the eager ops of its plain
version.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fit_tpu_torch.models.layers import fused_glue
from fit_tpu_torch.ops import LAUNCHES
from fit_tpu_torch.ops.fused_adaln import moe_combine, moe_combine_reference, swiglu_halves
from fit_tpu_torch.utils import profiling

__all__ = ["SparseMoeBlock", "route", "dispatch", "grouped"]


def route(x: torch.Tensor, gate: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(idx, w)`` (N, k): each row's top-k experts by the fp32 softmax of
    ``x @ gate^T``, and their scores, not renormalised. Ties go to the lower
    expert id (``torch.topk``'s order)."""
    scores = (x.float() @ gate.float().t()).softmax(dim=-1)
    w, idx = scores.topk(top_k, dim=-1)
    return idx, w


def dispatch(idx: torch.Tensor, num_experts: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(order, ends, pos)`` of the (N, k) assignments, on their device:
    ``order`` (N k,) the flat assignment ids (``token * k + slot``) sorted
    by expert, stably, so tokens keep their order inside an expert's block;
    ``ends`` (E,) int32 the cumulative row count of each expert's block;
    ``pos`` (N, k) the row each assignment landed in. No count is read on
    the host (``bincount`` would be)."""
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    experts = torch.arange(num_experts, device=idx.device, dtype=flat.dtype)
    ends = torch.searchsorted(flat[order], experts, right=True).to(torch.int32)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.numel(), device=idx.device)
    return order, ends, pos.view(idx.shape)


def grouped(x: torch.Tensor, plain: bool) -> bool:
    """Whether the experts run as grouped GEMMs on the device: a bf16 forward
    on the card that needs no backward (``torch._grouped_mm`` takes bf16
    on SM90; the plain loop has the backward and every other dtype)."""
    return not plain and x.is_cuda and x.dtype == torch.bfloat16 and not torch.is_grad_enabled()


class SparseMoeBlock(nn.Module):
    """The sparse-MoE FFN (see the module docstring). ``forward(x, dtype,
    plain)`` takes (B, T, D) rows in the compute dtype, as the block's other
    FFNs do, and returns (B, T, D) in x's dtype."""

    fp32_params = ("gate",)  # the router stays fp32 when the model is cast

    def __init__(self, dim: int, hidden: int, num_experts: int, top_k: int, shared_hidden: int, device=None):
        super().__init__()
        if not 0 < top_k <= num_experts:
            raise ValueError(f"top_k must lie in 1..num_experts ({num_experts}), got {top_k}")
        if shared_hidden <= 0:
            raise ValueError(f"the shared expert needs a width, got shared_hidden={shared_hidden}")
        self.dim, self.hidden, self.num_experts, self.top_k = dim, hidden, num_experts, top_k
        self.shared_hidden = shared_hidden
        self.gate = nn.Parameter(torch.empty(num_experts, dim, device=device))
        self.w_gate_up = nn.Parameter(torch.empty(num_experts, dim, 2 * hidden, device=device))
        self.w_down = nn.Parameter(torch.empty(num_experts, hidden, dim, device=device))
        self.shared_gate_up = nn.Parameter(torch.empty(dim, 2 * shared_hidden, device=device))
        self.shared_down = nn.Parameter(torch.empty(shared_hidden, dim, device=device))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """DiT-MoE's init: each expert's and the shared expert's projections
        xavier-uniform as the ``nn.Linear`` each one is there (fans D and its
        width), the router kaiming-uniform with ``a = sqrt(5)`` (bound
        1/sqrt(D))."""

        def xavier(p, fan_in, fan_out):
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            p.uniform_(-bound, bound, generator=generator)

        self.gate.uniform_(-1 / math.sqrt(self.dim), 1 / math.sqrt(self.dim), generator=generator)
        xavier(self.w_gate_up, self.dim, self.hidden)
        xavier(self.w_down, self.hidden, self.dim)
        xavier(self.shared_gate_up, self.dim, self.shared_hidden)
        xavier(self.shared_down, self.shared_hidden, self.dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype, plain: bool = False) -> torch.Tensor:
        b, t, d = x.shape
        n = b * t
        with profiling.span("moe.ffn"):
            profiling.count("moe.rows", n * self.top_k)
            x2 = x.reshape(n, d)
            idx, w = route(x2, self.gate, self.top_k)
            order, ends, pos = dispatch(idx, self.num_experts)
            rows = x2.index_select(0, order // self.top_k)
            if grouped(x, plain):
                ys = self._grouped_experts(rows, ends)
            else:
                ys = self._expert_loop(rows, ends, plain)
            shared = self._shared(x2, plain)
            if fused_glue(x, "none"):
                out = moe_combine(ys, pos, w, shared, plain=plain)
            else:
                out = moe_combine_reference(ys, pos, w, shared)
            return out.view(b, t, d)

    def _grouped_experts(self, rows: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
        """Each row through its expert: a grouped GEMM over the device's block
        ends, K6 on the ``[gate | up]`` halves, a grouped GEMM back."""
        gu = torch._grouped_mm(rows, self.w_gate_up.to(rows.dtype), offs=ends)
        h = swiglu_halves(gu)
        LAUNCHES["moe_grouped_mm"] += 2
        return torch._grouped_mm(h, self.w_down.to(rows.dtype), offs=ends)

    def _expert_loop(self, rows: torch.Tensor, ends: torch.Tensor, plain: bool) -> torch.Tensor:
        """The same, one expert at a time over the block ends read on the host."""
        out = rows.new_empty(rows.shape)
        start = 0
        for e, end in enumerate(ends.tolist()):
            if end > start:
                gu = rows[start:end] @ self.w_gate_up[e].to(rows.dtype)
                out[start:end] = _swiglu(gu, plain) @ self.w_down[e].to(rows.dtype)
            start = end
        return out

    def _shared(self, x2: torch.Tensor, plain: bool) -> torch.Tensor:
        gu = x2 @ self.shared_gate_up.to(x2.dtype)
        return _swiglu(gu, plain) @ self.shared_down.to(x2.dtype)


def _swiglu(gate_up: torch.Tensor, plain: bool) -> torch.Tensor:
    """The SwiGLU product of a ``[gate | up]`` projection: K6 (or its plain
    version) on the route ``layers.fused_glue`` gives the dense SwiGLU; the
    eager ops under grad, which K6 has no backward for, and on the CPU."""
    if fused_glue(gate_up, "none"):
        return swiglu_halves(gate_up, plain=plain)
    h = gate_up.shape[-1] // 2
    return F.silu(gate_up[..., :h]) * gate_up[..., h:]
