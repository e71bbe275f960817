"""DiT: the square-image Diffusion Transformer with absolute 2D sincos
positions, as a torch ``nn.Module``.

Counterpart of ``fit_tpu/models/dit.py``: patch embedding, a fixed sincos
table added to the embedded tokens, ``FiTBlock(ffn="mlp", use_rope=False)``
blocks (tanh-GELU MLP, attention without RoPE or mask, on the card through
K1 with RoPE off: ``fit_tpu_torch.ops.attention``), ``learn_sigma=True`` by
default (the 8-channel eps + variance output that LEARNED_RANGE diffusion
reads), the 3-channel guided forward and the 12-size registry.

DiT has no sampler class, as in ``fit_tpu``: it samples through
``create_diffusion(str(steps), learn_sigma=True)`` and
``p_sample_loop`` / ``ddim_sample_loop`` with ``forward_with_cfg`` bound to
its labels and guidance scale. With ``num_experts`` set it is DiT-MoE
(arXiv:2407.11633): every block's FFN is the sparse-MoE block of
``fit_tpu_torch.models.moe``; ``DiT_MoE_models`` holds its four published
sizes beside ``fit_tpu``'s twelve DiTs. ``dtype`` is the compute dtype; parameters
are created in fp32 and ``fit_tpu_torch.sampling.cast_for_sampling`` casts
them once. Setting ``plain_kernels`` routes every kernel wrapper to its
plain PyTorch version on any device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from fit_tpu_torch.core.geometry import patchify, unpatchify
from fit_tpu_torch.core.pos_embed import sincos_2d
from fit_tpu_torch.models.layers import FinalLayer, FiTBlock, LabelEmbedder, TimestepEmbedder, linear
from fit_tpu_torch.models.moe import SparseMoeBlock
from fit_tpu_torch.utils.device import resolve_device

__all__ = ["DiT", "DiT_models", "DiT_MoE_models", "create_dit"]


class DiT(nn.Module):
    """Square-image DiT. ``forward(x, t, y, train)`` with x: (N, C, H, W).

    The sincos table is built on the host for the input's (H/p, W/p) grid
    (``input_size`` only names the configuration's latent size, as in
    ``fit_tpu``), cast to the compute dtype before the add and kept per
    grid, device and dtype; it is not a parameter. ``generator`` and
    ``force_drop_ids`` drive training-mode label dropout as in ``FiT``.
    """

    def __init__(
        self,
        input_size: int = 32,
        patch_size: int = 2,
        in_channels: int = 4,
        hidden_size: int = 1152,
        depth: int = 28,
        num_heads: int = 16,
        mlp_ratio: float = 4.0,
        class_dropout_prob: float = 0.1,
        num_classes: int = 1000,
        learn_sigma: bool = True,
        dtype: torch.dtype = torch.float32,
        device=None,
        generator: Optional[torch.Generator] = None,
        num_experts: int = 0,
        num_experts_per_tok: int = 2,
        shared_hidden: int = 0,
    ):
        super().__init__()
        self.config = dict(
            input_size=input_size, patch_size=patch_size, in_channels=in_channels,
            hidden_size=hidden_size, depth=depth, num_heads=num_heads, mlp_ratio=mlp_ratio,
            class_dropout_prob=class_dropout_prob, num_classes=num_classes, learn_sigma=learn_sigma,
            dtype=dtype,
        )
        if num_experts:
            self.config.update(num_experts=num_experts, num_experts_per_tok=num_experts_per_tok,
                               shared_hidden=shared_hidden)
        self.input_size = input_size
        self.patch_size = patch_size
        self.in_channels = in_channels
        self.hidden_size = hidden_size
        self.depth = depth
        self.num_heads = num_heads
        self.num_classes = num_classes
        self.out_channels = in_channels * 2 if learn_sigma else in_channels
        self.dtype = dtype
        self.plain_kernels = False
        self._pos_tables: Dict[Tuple, torch.Tensor] = {}

        self.x_embedder = nn.Linear(patch_size * patch_size * in_channels, hidden_size, device=device)
        self.t_embedder = TimestepEmbedder(hidden_size, device=device)
        self.y_embedder = LabelEmbedder(num_classes, hidden_size, class_dropout_prob, device=device)
        moe = dict(ffn="sparse_moe", num_experts=num_experts, top_k=num_experts_per_tok,
                   shared_hidden=shared_hidden) if num_experts else dict(ffn="mlp")
        self.blocks = nn.ModuleList(
            FiTBlock(hidden_size, num_heads, mlp_ratio, use_rope=False, device=device, **moe)
            for _ in range(depth)
        )
        self.final = FinalLayer(hidden_size, patch_size, self.out_channels, device=device)
        self.reset_parameters(generator)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Reference init, as ``FiT.reset_parameters``: xavier-uniform Linear
        weights and zero biases (DiT-MoE's experts and router by
        ``SparseMoeBlock.reset_parameters``), normal(0.02) embedders, zero
        adaLN and final projection (an untrained model predicts 0)."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, SparseMoeBlock):
                m.reset_parameters(generator)
        for m in (self.t_embedder.fc1, self.t_embedder.fc2):
            nn.init.normal_(m.weight, std=0.02, generator=generator)
        nn.init.normal_(self.y_embedder.table.weight, std=0.02, generator=generator)
        for m in [blk.adaLN for blk in self.blocks] + [self.final.adaLN, self.final.linear]:
            nn.init.zeros_(m.weight)
            nn.init.zeros_(m.bias)

    def _pos_table(self, nh: int, nw: int, x: torch.Tensor) -> torch.Tensor:
        key = (nh, nw, x.device, x.dtype)
        if key not in self._pos_tables:
            table = torch.from_numpy(sincos_2d(self.hidden_size, nh, nw))
            self._pos_tables[key] = table.to(x.device).to(x.dtype)
        return self._pos_tables[key]

    def forward(
        self,
        x: torch.Tensor,
        t: torch.Tensor,
        y: torch.Tensor,
        train: bool = True,
        *,
        generator: Optional[torch.Generator] = None,
        force_drop_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        n, _, h, w = x.shape
        p = self.patch_size
        x = linear(self.x_embedder, patchify(x, p).to(self.dtype))
        x = x + self._pos_table(h // p, w // p, x)[None]
        c = self.t_embedder(t, self.dtype) + self.y_embedder(
            y, train, self.dtype, force_drop_ids=force_drop_ids, generator=generator
        )
        lengths = torch.full((n,), x.shape[1], dtype=torch.int32, device=x.device)
        for blk in self.blocks:
            x = blk(x, c, None, None, lengths, self.plain_kernels)
        x = self.final(x, c, self.plain_kernels)
        return unpatchify(x.float(), h, w, p, self.out_channels)

    def forward_with_cfg(self, x, t, y, cfg_scale: float) -> torch.Tensor:
        """Classifier-free-guidance forward on a batch packed as
        [conditional half | null-class half] with the same latents in both;
        guides the first 3 channels only and passes the others through
        (``fit_tpu``'s ``DiT.forward_with_cfg``; unlike FiT's, which guides
        all ``in_channels``)."""
        half = x[: x.shape[0] // 2]
        out = self(torch.cat([half, half], dim=0), t, y, train=False)
        eps, rest = out[:, :3], out[:, 3:]
        cond_eps, uncond_eps = eps.chunk(2, dim=0)
        guided = uncond_eps + cfg_scale * (cond_eps - uncond_eps)
        return torch.cat([torch.cat([guided, guided], dim=0), rest], dim=1)


_SIZES = {"XL": (28, 1152, 16), "L": (24, 1024, 16), "B": (12, 768, 12), "S": (12, 384, 6)}
# DiT-MoE (arXiv:2407.11633): depth, width, heads, routed experts; top-2 of
# them a token, expert width 4 D, and two shared experts as one SwiGLU of 2 D
_MOE_SIZES = {"S": (12, 384, 6, 8), "B": (12, 768, 12, 8), "XL": (28, 1152, 16, 8), "G": (40, 1408, 16, 16)}
_MOE_TOP_K, _MOE_SHARED = 2, 2


def _moe_name(size: str) -> str:
    return f"DiT-MoE-{size}/2-{_MOE_SIZES[size][3]}E{_MOE_TOP_K}A"


def create_dit(name: str, device="cuda", **kwargs) -> DiT:
    """A DiT by registry name, e.g. ``create_dit("DiT-XL/2", dtype=torch.bfloat16)``
    or ``create_dit("DiT-MoE-G/2-16E2A", device="meta")``, built on the card
    unless ``device`` names another (``"cpu"``, ``"meta"``)."""
    moe = {}
    if name.startswith("DiT-MoE-"):
        size = name.removeprefix("DiT-MoE-").split("/")[0]
        if name != _moe_name(size):
            raise KeyError(f"no DiT-MoE named {name!r}: the registry has {sorted(map(_moe_name, _MOE_SIZES))}")
        depth, hidden, heads, experts = _MOE_SIZES[size]
        patch = 2
        moe = dict(num_experts=experts, num_experts_per_tok=_MOE_TOP_K, shared_hidden=_MOE_SHARED * hidden)
    else:
        size, patch = name.removeprefix("DiT-").split("/")
        depth, hidden, heads = _SIZES[size]
    return DiT(
        depth=depth, hidden_size=hidden, num_heads=heads, patch_size=int(patch),
        device=resolve_device(device), **moe, **kwargs,
    )


DiT_models = {
    f"DiT-{size}/{patch}": (lambda name: lambda **kw: create_dit(name, **kw))(f"DiT-{size}/{patch}")
    for size in _SIZES
    for patch in (2, 4, 8)
}
DiT_MoE_models = {
    _moe_name(size): (lambda name: lambda **kw: create_dit(name, **kw))(_moe_name(size)) for size in _MOE_SIZES
}
