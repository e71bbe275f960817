"""Carry ``fit_tpu`` weights into the port.

``fit_tpu`` keeps a flax param tree: Dense kernels ``(in, out)`` (torch
``weight`` transposed), the qkv kernel head-grouped ``(D, 3, C)`` with bias
``(3, C)`` (the same memory order as flat ``(D, 3C)``), embeddings under
``embedding``, and the blocks either unrolled (``blocks_i``) or stacked for
scan-over-layers (``blocks/block`` with a leading depth axis). The same
walk carries a DiT tree and a FiT tree of any ``ffn`` / ``pos_kind``
(``ffn/fc1``, ``ffn/fc2`` of the GELU MLP): the port's attribute names are
the flax names, so no module needs a case of its own. A tree from
``fit_tpu.ops.quant.quantize_params`` carries across as well: its int8
kernels stay int8 and each ``kernel_scale`` stays fp32, the grouped qkv
scale ``(3, C)`` flattened to ``(3C,)``. The tree must hold numpy arrays
(``jax.tree.map(np.asarray, params)``), so this module never imports jax.

:func:`torch_vae_state_dict_from_flax` carries a ``fit_tpu`` VAE tree
(``fit_tpu.vae.AutoencoderKL``) into ``fit_tpu_torch.vae.AutoencoderKL``:
Conv kernels ``(kH, kW, I, O)`` become ``(O, I, kH, kW)``, Dense kernels
``(I, O)`` their transpose, GroupNorm ``scale`` the ``weight``.

:func:`torch_train_state_from_flax` carries a whole ``fit_tpu`` train
state (params, EMA shadow, and the Adam moments and count of its optax
AdamW or stochastic-rounding Adam) into the port's model, EMA and
optimizer state, so training resumes in the port where ``fit_tpu`` left off.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from fit_tpu_torch.train.state import AdamSR, TrainState, create_train_state

__all__ = ["torch_state_dict_from_flax", "torch_train_state_from_flax", "torch_vae_state_dict_from_flax"]


def _leaf_entries(prefix: str, node: Mapping) -> Dict[str, np.ndarray]:
    if "kernel" in node:
        kernel = np.asarray(node["kernel"])
        out = {
            f"{prefix}.weight": kernel.reshape(kernel.shape[0], -1).T,
            f"{prefix}.bias": np.asarray(node["bias"]).reshape(-1),
        }
        if "kernel_scale" in node:
            out[f"{prefix}.kernel_scale"] = np.asarray(node["kernel_scale"]).reshape(-1)
        return out
    if "embedding" in node:
        return {f"{prefix}.weight": np.asarray(node["embedding"])}
    out: Dict[str, np.ndarray] = {}
    for name, child in node.items():
        out.update(_leaf_entries(f"{prefix}.{name}" if prefix else name, child))
    return out


def torch_state_dict_from_flax(params_np: Mapping, depth: int) -> Dict[str, torch.Tensor]:
    """``fit_tpu`` FiT or DiT params (numpy leaves, with or without the
    outer ``"params"`` key) -> the port's ``FiT.state_dict()`` or
    ``DiT.state_dict()``."""
    tree = dict(params_np.get("params", params_np))
    if "blocks" in tree:  # scan-stacked: (depth, ...) leaves under blocks/block
        stacked = tree.pop("blocks")["block"]
        for i in range(depth):
            tree[f"blocks_{i}"] = _index_tree(stacked, i)
    blocks = {f"blocks.{i}": tree.pop(f"blocks_{i}") for i in range(depth)}
    entries = _leaf_entries("", tree)
    for prefix, node in blocks.items():
        entries.update(_leaf_entries(prefix, node))
    return {k: torch.from_numpy(_port_dtype(v)) for k, v in entries.items()}


def _port_dtype(v: np.ndarray) -> np.ndarray:
    """int8 kernels stay int8; every float leaf becomes a contiguous fp32 copy."""
    v = np.asarray(v)
    return np.array(v, dtype=np.int8 if v.dtype == np.int8 else np.float32)


def torch_vae_state_dict_from_flax(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """``fit_tpu`` AutoencoderKL params (numpy leaves, with or without the
    outer ``"params"`` key) -> the port's ``AutoencoderKL.state_dict()``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix: str, node: Mapping) -> None:
        for name, child in node.items():
            key = f"{prefix}.{name}" if prefix else name
            if isinstance(child, Mapping):
                walk(key, child)
                continue
            value = np.asarray(child, dtype=np.float32)
            if name == "kernel":
                value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
                key = f"{prefix}.weight"
            elif name == "scale":
                key = f"{prefix}.weight"
            out[key] = torch.from_numpy(np.array(value))  # a contiguous, writable copy

    walk("", params_np.get("params", params_np))
    return out


def _index_tree(node: Mapping, i: int):
    if isinstance(node, Mapping):
        return {k: _index_tree(v, i) for k, v in node.items()}
    return np.asarray(node)[i]


def torch_train_state_from_flax(
    jax_state: Any,
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    ema_dtype: torch.dtype = torch.float32,
) -> TrainState:
    """A ``fit_tpu`` ``TrainState`` with numpy leaves
    (``jax.tree.map(np.asarray, state)``) -> the port's :class:`TrainState`.

    ``jax_state`` has ``step``, ``params``, ``ema_params`` and
    ``opt_state``, whose first item holds the Adam ``count``, ``mu`` and
    ``nu`` (optax's ``ScaleByAdamState`` or ``scale_by_adam_sr``'s state);
    unrolled and scan-stacked trees both carry. ``model`` receives the
    params; ``optimizer`` (over ``model.parameters()``: ``torch.optim.AdamW``,
    or ``AdamSR`` for bf16 moments) receives ``exp_avg``, ``exp_avg_sq`` and
    ``step``; the EMA shadow is kept in ``ema_dtype``.
    """
    depth = model.depth
    device = next(model.parameters()).device
    model.load_state_dict(torch_state_dict_from_flax(jax_state.params, depth))
    state = create_train_state(model, optimizer, ema_dtype)
    with torch.no_grad():
        for name, value in torch_state_dict_from_flax(jax_state.ema_params, depth).items():
            state.ema[name].copy_(value)
    adam = jax_state.opt_state[0]
    mu = torch_state_dict_from_flax(adam.mu, depth)
    nu = torch_state_dict_from_flax(adam.nu, depth)
    moment_dtype = torch.bfloat16 if isinstance(optimizer, AdamSR) else torch.float32
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32),
            "exp_avg": mu[name].to(device, moment_dtype),
            "exp_avg_sq": nu[name].to(device, moment_dtype),
        }
    state.step = int(np.asarray(jax_state.step))
    return state
