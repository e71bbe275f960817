"""Train state: fp32 master params, AdamW, and the EMA shadow.

Counterpart of ``fit_tpu/train/state.py``. The optimizer is
``torch.optim.AdamW`` (lr, betas (0.9, 0.999), eps 1e-8, weight decay), the
update ``optax.adamw`` makes. ``optimizer_state_dtype="bfloat16"`` stores
the Adam moments and the EMA shadow in bf16 with stochastic rounding while
every update is computed in fp32: round-to-nearest would absorb the small
per-step increments ((1 - b2) = 1e-3 of nu, (1 - decay) = 1e-4 of the EMA),
which fall below bf16's ~2^-8 relative resolution, and stall the
accumulator. :class:`AdamSR` is the counterpart of ``scale_by_adam_sr``
followed by decoupled weight decay and ``-lr``.

Stochastic rounding draws its bits from an explicit ``torch.Generator``,
so it gives other bits than ``fit_tpu``'s; its contract (two neighbours,
unbiased, exact values unchanged) is what carries over. The EMA and the
optimizer update the parameters in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import torch
from torch import nn

__all__ = [
    "TrainState",
    "AdamSR",
    "create_train_state",
    "ema_update",
    "make_optimizer",
    "stochastic_round",
]


@dataclasses.dataclass
class TrainState:
    """The model (fp32 master params), its optimizer, the EMA shadow
    (parameter name -> tensor, fp32 or bf16) and the optimizer steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema: Dict[str, torch.Tensor]
    step: int = 0


def stochastic_round(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Unbiased fp32 -> bf16 cast: add 16 uniform random low bits to the
    fp32 pattern and truncate them. A value between two neighbouring bf16
    numbers rounds up with probability (x - lower) / ulp, so the mean is x
    (finite x; carries move into the exponent at binade edges). Bits come
    from ``generator`` (on x's device)."""
    if x.dtype != torch.float32:
        raise TypeError(f"stochastic_round takes fp32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    rnd = torch.randint(0, 1 << 16, x.shape, generator=generator, device=x.device, dtype=torch.int32)
    return ((bits + rnd) & -65536).view(torch.float32).to(torch.bfloat16)


class AdamSR(torch.optim.Optimizer):
    """AdamW whose moments ``exp_avg`` / ``exp_avg_sq`` are stored in bf16
    by stochastic rounding; the moment update, the bias correction and the
    step are fp32, from this step's exact fp32 moments (as
    ``scale_by_adam_sr``): ``p -= lr * (m_hat / (sqrt(v_hat) + eps) +
    weight_decay * p)``."""

    def __init__(
        self,
        params: Iterable,
        lr: float = 1e-4,
        betas=(0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        *,
        generator: torch.Generator,
    ):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        self.generator = generator

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamSR takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32)
                    st["exp_avg"] = torch.zeros_like(p, dtype=torch.bfloat16)
                    st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.bfloat16)
                st["step"] += 1
                count = st["step"].item()
                g = p.grad.float()
                mu = b1 * st["exp_avg"].float() + (1.0 - b1) * g
                nu = b2 * st["exp_avg_sq"].float() + (1.0 - b2) * g.square()
                direction = (mu / (1.0 - b1**count)) / ((nu / (1.0 - b2**count)).sqrt() + group["eps"])
                p.sub_(group["lr"] * (direction + group["weight_decay"] * p))
                st["exp_avg"] = stochastic_round(mu, self.generator)
                st["exp_avg_sq"] = stochastic_round(nu, self.generator)

    def load_state_dict(self, state_dict) -> None:
        """As ``Optimizer.load_state_dict``, which casts the moments to the
        parameters' dtype; they go back to bf16 (exactly: they were bf16)."""
        super().load_state_dict(state_dict)
        for st in self.state.values():
            for key in ("exp_avg", "exp_avg_sq"):
                if key in st:
                    st[key] = st[key].to(torch.bfloat16)


def make_optimizer(
    params: Iterable,
    learning_rate: float = 1e-4,
    weight_decay: float = 0.0,
    moment_dtype: Optional[torch.dtype] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.optim.Optimizer:
    """The reference optimizer, AdamW(lr 1e-4, betas (0.9, 0.999), eps
    1e-8, weight decay 0); ``moment_dtype=torch.bfloat16`` stores the
    moments in bf16 by stochastic rounding from ``generator``."""
    if moment_dtype is None or moment_dtype == torch.float32:
        return torch.optim.AdamW(
            params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay
        )
    if moment_dtype != torch.bfloat16:
        raise ValueError(f"moments are stored in fp32 or bf16, not {moment_dtype}")
    if generator is None:
        raise ValueError("bf16 moments need a generator for their stochastic rounding")
    return AdamSR(params, lr=learning_rate, weight_decay=weight_decay, generator=generator)


@torch.no_grad()
def ema_update(
    ema: Dict[str, torch.Tensor],
    params: Dict[str, torch.Tensor],
    decay: float = 0.9999,
    generator: Optional[torch.Generator] = None,
) -> None:
    """``ema = decay * ema + (1 - decay) * params``, in place. A shadow
    stored in bf16 takes the fp32 lerp stochastically rounded with
    ``generator`` (round-to-nearest would freeze it)."""
    fp32 = [name for name, e in ema.items() if e.dtype == torch.float32]
    if fp32:  # two fused passes over every fp32 shadow tensor
        shadow = [ema[n] for n in fp32]
        torch._foreach_mul_(shadow, decay)
        torch._foreach_add_(shadow, [params[n].float() for n in fp32], alpha=1.0 - decay)
    for name, e in ema.items():
        if e.dtype == torch.float32:
            continue
        lerped = decay * e.float() + (1.0 - decay) * params[name].float()
        if generator is None:
            raise ValueError(
                f"ema_update: a shadow stored in {e.dtype} needs a generator for stochastic rounding"
            )
        e.copy_(stochastic_round(lerped, generator))


def create_train_state(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    ema_dtype: torch.dtype = torch.float32,
) -> TrainState:
    """A state at step 0 whose EMA shadow is a copy of the parameters in
    ``ema_dtype``."""
    ema = {n: p.detach().to(ema_dtype, copy=True) for n, p in model.named_parameters()}
    return TrainState(model=model, optimizer=optimizer, ema=ema)
