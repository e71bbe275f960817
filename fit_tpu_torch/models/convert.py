"""Load reference (PyTorch Lightning) FiT checkpoints into the port.

Counterpart of ``fit_tpu/models/convert.py``. The reference's module tree
(``x_embedder``, ``t_embedder.mlp.{0,2}``, ``y_embedder.embedding_table``,
``blocks.N.{attn.qkv, attn.proj, ffn.*, adaLN_modulation.1}``,
``final_layer.{linear, adaLN_modulation.1}``; affine-free LayerNorms carry
no weights) already has torch's ``(out, in)`` layout, so the conversion is
renames only. Lightning's ``model.`` and ``torch.compile``'s
``_orig_mod.`` prefixes are stripped. EMA weights come from a ``-EMA``
file, a ``-EMA`` sidecar or the optimizer state, as ``fit_tpu`` finds them.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Mapping, Optional, Tuple

import torch

__all__ = [
    "convert_torch_fit_state_dict",
    "load_torch_fit_checkpoint",
    "resolve_reference_state_dict",
]

_STRIP_PREFIXES = ("model._orig_mod.", "model.", "_orig_mod.")

# reference name -> port name, applied in order to the stripped key
_RENAMES = (
    (re.compile(r"^t_embedder\.mlp\.0\."), "t_embedder.fc1."),
    (re.compile(r"^t_embedder\.mlp\.2\."), "t_embedder.fc2."),
    (re.compile(r"^y_embedder\.embedding_table\."), "y_embedder.table."),
    (re.compile(r"^blocks\.(\d+)\.adaLN_modulation\.1\."), r"blocks.\1.adaLN."),
    (re.compile(r"^final_layer\.adaLN_modulation\.1\."), "final.adaLN."),
    (re.compile(r"^final_layer\.linear\."), "final.linear."),
)


def _strip(key: str) -> str:
    for p in _STRIP_PREFIXES:
        if key.startswith(p):
            return key[len(p):]
    return key


def _rename(key: str) -> str:
    key = _strip(key)
    for pattern, repl in _RENAMES:
        key, n = pattern.subn(repl, key)
        if n:
            break
    return key


def convert_torch_fit_state_dict(
    sd: Mapping, expected: Optional[Mapping[str, torch.Tensor]] = None
) -> Dict[str, torch.Tensor]:
    """A reference FiT state dict (tensors or numpy arrays, with or without
    the Lightning prefixes) -> the port's ``FiT.state_dict()`` names, fp32.

    ``expected`` (a ``FiT.state_dict()``) checks the result: a key it
    lacks, a key the checkpoint lacks or a shape that differs raises,
    naming the key."""
    out = {_rename(k): torch.as_tensor(v).float() for k, v in sd.items()}
    if expected is not None:
        unknown = [k for k in out if k not in expected]
        missing = [k for k in expected if k not in out]
        if unknown or missing:
            raise KeyError(
                f"the checkpoint does not fit the model: unknown keys {unknown[:8]}, missing keys {missing[:8]}"
            )
        for k, v in out.items():
            if tuple(v.shape) != tuple(expected[k].shape):
                raise ValueError(f"shape mismatch at {k}: checkpoint {tuple(v.shape)}, model {tuple(expected[k].shape)}")
    return out


def _ema_list_from_optimizer_states(obj) -> Optional[list]:
    """The reference's ``EMAOptimizer`` keeps its EMA weights as an ordered
    list under ``optimizer_states[0]['ema']``."""
    states = obj.get("optimizer_states") if isinstance(obj, dict) else None
    if not states:
        return None
    st = states[0]
    if isinstance(st, dict) and "ema" in st:
        return list(st["ema"])
    return None


def _map_ema_onto_keys(sd: Mapping, ema_list: list) -> Dict:
    """The EMA list mapped by position onto the reference's state-dict keys
    (its ``parameters()`` order, which is its state-dict order: the module
    has no buffers). Renaming comes after, in the converter."""
    keys = list(sd.keys())
    if len(keys) != len(ema_list):
        raise ValueError(
            f"cannot map EMA weights: {len(ema_list)} EMA params vs {len(keys)} state_dict entries"
        )
    out = {}
    for k, e in zip(keys, ema_list):
        if tuple(e.shape) != tuple(sd[k].shape):
            raise ValueError(f"EMA param shape mismatch at {k}: {tuple(e.shape)} vs {tuple(sd[k].shape)}")
        out[k] = e
    return out


def _load(path: str):
    # Lightning checkpoints pickle more than tensors (hyperparameters, loop
    # state), so they need the full unpickler
    return torch.load(path, map_location="cpu", weights_only=False)


def resolve_reference_state_dict(path: str, prefer_ema: bool = True) -> Tuple[Dict, bool]:
    """Load a reference checkpoint -> ``(state_dict, used_ema)``, keys as
    the reference names them.

    With ``prefer_ema`` the EMA weights come from, in order: a ``-EMA``
    file itself (its weights are the EMA copy), a ``-EMA`` sidecar next to
    ``path``, then ``optimizer_states[0]['ema']`` inside the checkpoint;
    without any of them, the raw weights."""
    obj = _load(path)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    if not prefer_ema:
        return dict(sd), False
    root, ext = os.path.splitext(path)
    if root.endswith("-EMA"):
        return dict(sd), True
    sidecar = f"{root}-EMA{ext}"
    if os.path.exists(sidecar):
        side = _load(sidecar)
        ema_list = _ema_list_from_optimizer_states(side)
        if ema_list is not None:
            return _map_ema_onto_keys(sd, ema_list), True
        side_sd = side.get("state_dict") if isinstance(side, dict) else None
        if side_sd:
            return dict(side_sd), True
    ema_list = _ema_list_from_optimizer_states(obj)
    if ema_list is not None:
        return _map_ema_onto_keys(sd, ema_list), True
    return dict(sd), False


def load_torch_fit_checkpoint(
    path: str, expected: Optional[Mapping[str, torch.Tensor]] = None, prefer_ema: bool = True
) -> Dict[str, torch.Tensor]:
    """A reference checkpoint file -> the port's state dict (EMA weights
    when the file carries them and ``prefer_ema``), checked against
    ``expected`` when given (:func:`convert_torch_fit_state_dict`)."""
    sd, used_ema = resolve_reference_state_dict(path, prefer_ema=prefer_ema)
    if used_ema:
        print(f"[fit_tpu_torch] using EMA weights from {path}")
    return convert_torch_fit_state_dict(sd, expected)
