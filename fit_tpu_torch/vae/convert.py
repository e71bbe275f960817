"""Load a diffusers ``AutoencoderKL`` checkpoint into the port's VAE.

Counterpart of ``fit_tpu/vae/convert.py``. A diffusers convolution
``(O, I, kH, kW)`` is already the port's layout, so the conversion renames
keys onto ``fit_tpu``'s module names (``encoder.down_blocks.{i}.resnets.{j}``
-> ``encoder.down_{i}_block_{j}``, ...). The mid-block attention comes in
two styles: diffusers' ``group_norm`` with ``to_q`` / ``to_k`` / ``to_v`` /
``to_out.0`` Linears, and the older ldm ``norm`` with 1x1-convolution ``q``
/ ``k`` / ``v`` / ``proj_out`` (squeezed to Linear weights). A missing or
an unknown key raises, naming it. :func:`to_diffusers_state_dict` maps
back, in either attention style.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Mapping, Sequence

import numpy as np
import torch

__all__ = [
    "convert_state_dict",
    "to_diffusers_state_dict",
    "infer_config",
    "load_checkpoint",
    "resolve_checkpoint",
    "load_autoencoder",
    "convert_torch_state_dict",
    "load_torch_checkpoint",
]

_RESNET = ("norm1", "conv1", "norm2", "conv2")
_ATTN_STYLES = {
    "new": {"norm": "group_norm", "q": "to_q", "k": "to_k", "v": "to_v", "proj_out": "to_out.0"},
    "old": {"norm": "norm", "q": "q", "k": "k", "v": "v", "proj_out": "proj_out"},
}
_DENSE = ("q", "k", "v", "proj_out")


def _module_names(block_out_channels: Sequence[int], enc_layers: int, dec_layers: int,
                  has_shortcut: Callable[[str, str], bool], attn_style: Callable[[str], str]) -> Dict[str, str]:
    """The port's module names -> the diffusers module names.
    ``has_shortcut(ours, theirs)`` says whether a resnet has a 1x1
    shortcut; ``attn_style(theirs)`` names an attention's style."""
    names = {
        "encoder.conv_in": "encoder.conv_in",
        "encoder.norm_out": "encoder.conv_norm_out",
        "encoder.conv_out": "encoder.conv_out",
        "encoder.quant_conv": "quant_conv",
        "decoder.post_quant_conv": "post_quant_conv",
        "decoder.conv_in": "decoder.conv_in",
        "decoder.norm_out": "decoder.conv_norm_out",
        "decoder.conv_out": "decoder.conv_out",
    }

    def resnet(ours, theirs):
        names.update({f"{ours}.{n}": f"{theirs}.{n}" for n in _RESNET})
        if has_shortcut(ours, theirs):
            names[f"{ours}.shortcut"] = f"{theirs}.conv_shortcut"

    last = len(block_out_channels) - 1
    for side in ("encoder", "decoder"):
        resnet(f"{side}.mid_block_1", f"{side}.mid_block.resnets.0")
        attn = f"{side}.mid_block.attentions.0"
        names.update({f"{side}.mid_attn.{a}": f"{attn}.{b}" for a, b in _ATTN_STYLES[attn_style(attn)].items()})
        resnet(f"{side}.mid_block_2", f"{side}.mid_block.resnets.1")
    for i in range(len(block_out_channels)):
        for j in range(enc_layers):
            resnet(f"encoder.down_{i}_block_{j}", f"encoder.down_blocks.{i}.resnets.{j}")
        for j in range(dec_layers):
            resnet(f"decoder.up_{i}_block_{j}", f"decoder.up_blocks.{i}.resnets.{j}")
        if i < last:
            names[f"encoder.down_{i}_downsample.conv"] = f"encoder.down_blocks.{i}.downsamplers.0.conv"
            names[f"decoder.up_{i}_upsample.conv"] = f"decoder.up_blocks.{i}.upsamplers.0.conv"
    return names


def _tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(value, dtype=np.float32))


def convert_state_dict(sd: Mapping, block_out_channels: Sequence[int] = (128, 256, 512, 512), enc_layers: int = 2,
                       dec_layers: int = 3) -> Dict[str, torch.Tensor]:
    """A diffusers ``AutoencoderKL`` state dict (tensors or arrays) -> the
    port's ``AutoencoderKL.state_dict()``, fp32 on the CPU."""
    out: Dict[str, torch.Tensor] = {}
    used = set()
    names = _module_names(block_out_channels, enc_layers, dec_layers,
                          has_shortcut=lambda ours, theirs: f"{theirs}.conv_shortcut.weight" in sd,
                          attn_style=lambda theirs: "new" if f"{theirs}.to_q.weight" in sd else "old")
    for ours, theirs in names.items():
        for leaf in ("weight", "bias"):
            key = f"{theirs}.{leaf}"
            if key not in sd:
                raise KeyError(f"the VAE checkpoint has no {key!r} (for {ours}.{leaf})")
            value = _tensor(sd[key])
            if leaf == "weight" and ours.rsplit(".", 1)[-1] in _DENSE and value.dim() == 4:
                value = value[:, :, 0, 0]  # the ldm style's 1x1 convolution
            out[f"{ours}.{leaf}"] = value
            used.add(key)
    unknown = sorted(set(sd) - used)
    if unknown:
        raise KeyError(f"the VAE checkpoint has keys this AutoencoderKL does not: {unknown[:8]}")
    return out


def to_diffusers_state_dict(state: Mapping[str, torch.Tensor], block_out_channels: Sequence[int] = (128, 256, 512, 512),
                            attn_style: str = "new", enc_layers: int = 2, dec_layers: int = 3) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`convert_state_dict`: the port's state dict ->
    diffusers names, the mid-block attentions in ``attn_style`` ("new":
    Linears, "old": 1x1 convolutions)."""
    names = _module_names(block_out_channels, enc_layers, dec_layers,
                          has_shortcut=lambda ours, theirs: f"{ours}.shortcut.weight" in state,
                          attn_style=lambda theirs: attn_style)
    out = {}
    for ours, theirs in names.items():
        for leaf in ("weight", "bias"):
            value = state[f"{ours}.{leaf}"]
            if leaf == "weight" and attn_style == "old" and ours.rsplit(".", 1)[-1] in _DENSE:
                value = value[:, :, None, None]
            out[f"{theirs}.{leaf}"] = value
    return out


def infer_config(sd: Mapping) -> dict:
    """``block_out_channels`` and ``latent_channels`` of a diffusers state
    dict, from its encoder blocks' widths."""
    widths = []
    while f"encoder.down_blocks.{len(widths)}.resnets.0.conv1.weight" in sd:
        widths.append(int(sd[f"encoder.down_blocks.{len(widths)}.resnets.0.conv1.weight"].shape[0]))
    if not widths or "post_quant_conv.weight" not in sd:
        raise KeyError("not a diffusers AutoencoderKL state dict: no encoder.down_blocks.0 or post_quant_conv")
    return {"block_out_channels": tuple(widths), "latent_channels": int(sd["post_quant_conv.weight"].shape[0])}


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The raw state dict of a ``.bin`` / ``.pt`` / ``.pth`` (``torch.load``,
    weights only) or ``.safetensors`` file (needs the ``safetensors``
    package)."""
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as exc:
            raise ImportError(f"reading {path} needs the 'safetensors' package, which is not installed") from exc
        return load_file(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def resolve_checkpoint(path: str, kind: str = "ema") -> str:
    """``path`` itself if it is a file; in a directory, the
    ``sd-vae-ft-{kind}`` checkpoint (``kind`` "ema" or "mse")."""
    if not os.path.isdir(path):
        return path
    for ext in (".bin", ".safetensors", ".pt", ".pth"):
        cand = os.path.join(path, f"sd-vae-ft-{kind}{ext}")
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"no sd-vae-ft-{kind} checkpoint under {path}")


def load_autoencoder(path: str, kind: str = "ema", dtype=torch.float32, device="cuda"):
    """An :class:`AutoencoderKL` computing in ``dtype`` on ``device`` (the
    card unless the caller names another), its widths and weights from the
    diffusers checkpoint at ``path`` (a file, or a directory resolved by
    ``kind``)."""
    from fit_tpu_torch.vae.model import AutoencoderKL

    sd = load_checkpoint(resolve_checkpoint(path, kind))
    cfg = infer_config(sd)
    vae = AutoencoderKL(**cfg, dtype=dtype, device=device)
    vae.load_state_dict(convert_state_dict(sd, cfg["block_out_channels"]))
    return vae.eval()


# fit_tpu's names for the same two functions
convert_torch_state_dict = convert_state_dict
load_torch_checkpoint = load_checkpoint
