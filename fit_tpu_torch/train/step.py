"""The training step: noising, masked-MSE loss, gradient accumulation,
AdamW update, EMA.

Counterpart of ``fit_tpu/train/step.py``. Per micro-batch it draws uniform
timesteps (unless the batch carries ``t``), Gaussian noise and the label
dropout from one ``torch.Generator``, forms ``x_t`` with the linear
alpha-bar table, runs the denoiser on the padded tokens and takes one
global mean of the squared error over the valid tokens
(``F.mse_loss(out[mask], noise[mask])``); with importance weights
``t_weight`` in the batch, the weighted mean of per-sample masked MSEs.

Gradient accumulation: the micro-batches' gradients are summed by
``backward`` and divided by their number, then one optimizer step and one
EMA update run, as ``fit_tpu``'s scan over the micro-batch axis does.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn
from torch.func import functional_call

from fit_tpu_torch.diffusion.gaussian import GaussianDiffusion, masked_global_mse
from fit_tpu_torch.train.state import TrainState, ema_update

__all__ = [
    "diffusion_loss",
    "make_train_step",
    "make_eval_step",
    "split_for_accumulation",
    "global_norm",
]


def masked_per_sample_mse(out: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B,) mean squared error over each sample's valid tokens."""
    m = mask[..., None].float()
    se = ((out - target).square() * m).sum(dim=(1, 2))
    denom = mask.float().sum(dim=1) * out.shape[-1]
    return se / denom.clamp(min=1.0)


def diffusion_loss(
    model: nn.Module,
    diffusion: GaussianDiffusion,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    *,
    params: Optional[Dict[str, torch.Tensor]] = None,
):
    """Masked eps-prediction MSE of one micro-batch. Returns
    ``(loss, (t, per_sample_loss))``; t and the per-sample losses feed the
    loss-second-moment timestep sampler's history.

    ``batch``: tokens (B,T,D), pos (B,T,P), mask (B,T), label (B,), and
    optionally lengths (B,) int32 (the mask's prefix lengths, checked by
    the caller, which spares the forward a host round trip) and t_weight
    (B,) importance weights. ``t`` (B,), ``noise`` (B,T,D) fp32 and
    ``drop_ids`` (B,) (1 = null class) in the batch replace their draws;
    what is not given is drawn from ``generator``, in the order t, noise,
    label dropout. ``params`` (name -> tensor, e.g. the EMA shadow) replace
    the model's own parameters.
    """
    tokens = batch["tokens"]
    b = tokens.shape[0]
    t = batch.get("t")
    if t is None:
        t = torch.randint(0, diffusion.original_num_steps, (b,), generator=_need(generator), device=tokens.device)
    noise = batch.get("noise")
    if noise is None:
        noise = torch.randn(tokens.shape, generator=_need(generator), device=tokens.device, dtype=torch.float32)
    x_t = diffusion.q_sample(tokens.float(), t, noise)
    args = (x_t, t, batch["label"], batch["pos"], batch["mask"])
    kwargs = dict(train=True, lengths=batch.get("lengths"), generator=generator, force_drop_ids=batch.get("drop_ids"))
    out = functional_call(model, params, args, kwargs) if params is not None else model(*args, **kwargs)
    outf = out.float()
    per_sample = masked_per_sample_mse(outf, noise, batch["mask"])
    if "t_weight" in batch:
        loss = (batch["t_weight"] * per_sample).mean()
    else:
        loss = masked_global_mse(outf, noise, batch["mask"])
    return loss, (t, per_sample)


def _need(generator: Optional[torch.Generator]) -> torch.Generator:
    if generator is None:
        raise ValueError("the training draws come from a generator: pass one, or inject t and noise")
    return generator


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    norms = torch._foreach_norm([x.float() for x in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def split_for_accumulation(batch: Dict[str, torch.Tensor], grad_accum: int) -> Dict[str, torch.Tensor]:
    """Reshape (B, ...) arrays to (grad_accum, B // grad_accum, ...)."""
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if b % grad_accum:
            raise ValueError(f"batch {b} is not divisible by grad_accum {grad_accum}")
        out[k] = v.reshape((grad_accum, b // grad_accum) + tuple(v.shape[1:]))
    return out


def make_train_step(
    diffusion: GaussianDiffusion,
    *,
    ema_decay: float = 0.9999,
    grad_accum: int = 1,
    sr_generator: Optional[torch.Generator] = None,
) -> Callable:
    """The train step ``step(state, batch, generator) -> (state, metrics)``.

    With ``grad_accum > 1`` every batch tensor has a leading
    ``(grad_accum, micro_batch, ...)`` shape (:func:`split_for_accumulation`).
    The state is updated in place. ``metrics`` holds device tensors (no host
    sync): loss (the micro-batches' mean), grad_norm, and the drawn t with
    each sample's loss; ``step`` is the new step count. ``sr_generator``
    rounds a bf16 EMA shadow.
    """

    def step(state: TrainState, batch: Dict[str, torch.Tensor], generator: torch.Generator):
        model, optimizer = state.model, state.optimizer
        optimizer.zero_grad(set_to_none=True)
        micros = [batch] if grad_accum == 1 else [{k: v[i] for k, v in batch.items()} for i in range(grad_accum)]
        losses, ts, t_losses = [], [], []
        for micro in micros:
            loss, (t, per_sample) = diffusion_loss(model, diffusion, micro, generator)
            loss.backward()
            losses.append(loss.detach())
            ts.append(t)
            t_losses.append(per_sample.detach())
        named = dict(model.named_parameters())
        grads = [p.grad for p in named.values() if p.grad is not None]
        if grad_accum > 1:
            torch._foreach_div_(grads, float(grad_accum))
        grad_norm = global_norm(grads)
        optimizer.step()
        ema_update(state.ema, {n: p.detach() for n, p in named.items()}, ema_decay, sr_generator)
        state.step += 1
        metrics = {
            "loss": torch.stack(losses).mean(),
            "grad_norm": grad_norm,
            "step": state.step,
            "t": torch.cat(ts),
            "t_loss": torch.cat(t_losses),
        }
        return state, metrics

    return step


def make_eval_step(diffusion: GaussianDiffusion) -> Callable:
    """Validation loss ``eval_step(model, params, batch, generator)``: the
    training loss without gradients, under ``params`` (e.g. the EMA shadow;
    None: the model's own)."""

    @torch.no_grad()
    def step(model, params, batch, generator):
        return diffusion_loss(model, diffusion, batch, generator, params=params)[0]

    return step
