"""FiT: Flexible Vision Transformer for diffusion, as a torch ``nn.Module``.

Counterpart of ``fit_tpu/models/fit.py`` for dense blocks: a DiT-style
transformer over packed variable-length token sequences with a prefix
validity mask and per-token 2D RoPE tables (``pos_kind="rotate"``) or
additive sincos tables (``pos_kind="absolute"``, attention without RoPE),
with SwiGLU (``ffn="swiglu"``) or tanh-GELU MLP (``ffn="mlp"``) blocks.

``dtype`` is the compute dtype. Parameters are created in fp32 on
``device``; :class:`fit_tpu_torch.sampling.FiTSampler` casts them to the
compute dtype once, and until then each projection casts on the fly.
``quant="int8"`` builds the w8a8 serving model (``fit_tpu_torch.ops.quant``):
its int8 weights come from ``quantize_params`` / ``quantize_model``, never
from init or training. ``remat=True`` recomputes each block in the backward
(``torch.utils.checkpoint``), as ``fit_tpu``'s ``nn.remat(FiTBlock)``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from fit_tpu_torch.core.geometry import patchify, unpatchify
from fit_tpu_torch.models.layers import (
    FinalLayer,
    FiTBlock,
    LabelEmbedder,
    TimestepEmbedder,
    linear,
)
from fit_tpu_torch.ops.rope_attention import split_rope_tables
from fit_tpu_torch.utils.device import resolve_device

__all__ = ["FiT", "FiT_models", "create_fit", "lengths_from_mask"]


def lengths_from_mask(mask: Optional[torch.Tensor], n: int, t: int, device) -> torch.Tensor:
    """(N, T) boolean prefix mask -> (N,) int32 lengths; all T when None.
    Raises if a row has no valid token (its softmax would be empty). The
    check reads the lengths back to the host, so a caller that builds its
    masks on the host checks them there and passes ``lengths`` to the
    forward instead (``fit_tpu_torch.sampling``)."""
    if mask is None:
        return torch.full((n,), t, dtype=torch.int32, device=device)
    lengths = mask.sum(dim=-1, dtype=torch.int32)
    if bool((lengths < 1).any()):
        raise ValueError("every mask row needs at least one valid token")
    return lengths


class FiT(nn.Module):
    """The FiT denoiser.

    ``forward(x, t, y, pos, mask, train)``: ``x`` is tokens ``(N, T, p*p*C)``
    when ``train`` is true, or a latent canvas ``(N, C, H, W)`` otherwise
    (patchified and unpatchified inside; the sampling path). ``t``, ``y``:
    ``(N,)`` timesteps and labels. ``pos``: ``(N, T, head_dim)`` interleaved
    RoPE tables (``pos_kind="rotate"``) or ``(N, T, hidden)`` sincos tables
    added to the embedded tokens (``pos_kind="absolute"``). ``mask``:
    ``(N, T)`` boolean prefix validity mask.

    ``lengths``: ``(N,)`` int32 prefix lengths, each at least 1, in place
    of ``mask`` (checked by the caller; no host round trip).

    ``generator``: the draws of training-mode label dropout (on the
    labels' device); ``force_drop_ids`` (N,) replaces them (1 = null class).

    ``quant``: "none", or "int8" for the w8a8 serving path. Setting
    ``plain_kernels`` routes every kernel wrapper (attention, the row glue
    and the int8 epilogues) to its plain PyTorch version on any device: the
    on-card reference the kernels are held against.
    """

    def __init__(
        self,
        patch_size: int = 2,
        in_channels: int = 4,
        hidden_size: int = 1152,
        depth: int = 28,
        num_heads: int = 16,
        mlp_ratio: float = 4.0,
        class_dropout_prob: float = 0.1,
        num_classes: int = 1000,
        learn_sigma: bool = False,
        quant: str = "none",
        dtype: torch.dtype = torch.float32,
        remat: bool = False,
        ffn: str = "swiglu",
        pos_kind: str = "rotate",
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if quant not in ("none", "int8"):
            raise ValueError(f"unknown quant {quant!r}: use 'none' or 'int8'")
        if pos_kind not in ("rotate", "absolute"):
            raise ValueError(f"unknown pos_kind {pos_kind!r}: use 'rotate' or 'absolute'")
        self.config = dict(
            patch_size=patch_size, in_channels=in_channels, hidden_size=hidden_size, depth=depth,
            num_heads=num_heads, mlp_ratio=mlp_ratio, class_dropout_prob=class_dropout_prob,
            num_classes=num_classes, learn_sigma=learn_sigma, quant=quant, dtype=dtype, remat=remat,
            ffn=ffn, pos_kind=pos_kind,
        )
        self.patch_size = patch_size
        self.in_channels = in_channels
        self.hidden_size = hidden_size
        self.depth = depth
        self.num_heads = num_heads
        self.num_classes = num_classes
        self.out_channels = in_channels * 2 if learn_sigma else in_channels
        self.quant = quant
        self.dtype = dtype
        self.remat = remat
        self.pos_kind = pos_kind
        self.plain_kernels = False

        self.x_embedder = nn.Linear(patch_size * patch_size * in_channels, hidden_size, device=device)
        self.t_embedder = TimestepEmbedder(hidden_size, device=device)
        self.y_embedder = LabelEmbedder(num_classes, hidden_size, class_dropout_prob, device=device)
        self.blocks = nn.ModuleList(
            FiTBlock(hidden_size, num_heads, mlp_ratio, quant, ffn, pos_kind == "rotate", device=device)
            for _ in range(depth)
        )
        self.final = FinalLayer(hidden_size, patch_size, self.out_channels, quant, device=device)
        self.reset_parameters(generator)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Reference init: xavier-uniform Linear weights and zero biases,
        normal(0.02) embedders, zero adaLN and final projection (so an
        untrained model predicts eps = 0). The draws come from ``generator``
        (on the parameters' device) when one is given."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                nn.init.zeros_(m.bias)
        for m in (self.t_embedder.fc1, self.t_embedder.fc2):
            nn.init.normal_(m.weight, std=0.02, generator=generator)
        nn.init.normal_(self.y_embedder.table.weight, std=0.02, generator=generator)
        for m in [blk.adaLN for blk in self.blocks] + [self.final.adaLN, self.final.linear]:
            nn.init.zeros_(m.weight)
            nn.init.zeros_(m.bias)

    def forward(
        self,
        x: torch.Tensor,
        t: torch.Tensor,
        y: torch.Tensor,
        pos: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        train: bool = True,
        *,
        lengths: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        force_drop_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if not train:
            h, w = x.shape[-2:]
            x = patchify(x, self.patch_size)
        n, seq = x.shape[:2]
        x = linear(self.x_embedder, x.to(self.dtype))
        if self.pos_kind == "absolute":
            x = x + pos.to(x.dtype)
            cos = sin = None
        else:
            cos, sin = split_rope_tables(pos)
        if lengths is None:
            lengths = lengths_from_mask(mask, n, seq, x.device)
        c = self.t_embedder(t, self.dtype) + self.y_embedder(
            y, train, self.dtype, force_drop_ids=force_drop_ids, generator=generator
        )
        remat = self.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            if remat:
                x = checkpoint(blk, x, c, cos, sin, lengths, self.plain_kernels, use_reentrant=False)
            else:
                x = blk(x, c, cos, sin, lengths, self.plain_kernels)
        x = self.final(x, c, self.plain_kernels)
        if not train:
            x = unpatchify(x.float(), h, w, self.patch_size, self.out_channels)
        return x

    def forward_with_cfg(self, x, t, y, pos, mask, cfg_scale: float, *, lengths=None) -> torch.Tensor:
        """Classifier-free-guidance forward on a canvas batch packed as
        [conditional half | null-class half] with the same latents in both;
        the guided eps (all ``in_channels``) is returned in both halves."""
        half = x[: x.shape[0] // 2]
        out = self(torch.cat([half, half], dim=0), t, y, pos, mask, train=False, lengths=lengths)
        eps, rest = out[:, : self.in_channels], out[:, self.in_channels :]
        cond_eps, uncond_eps = eps.chunk(2, dim=0)
        guided = uncond_eps + cfg_scale * (cond_eps - uncond_eps)
        return torch.cat([torch.cat([guided, guided], dim=0), rest], dim=1)


_SIZES = {"XL": (28, 1152, 16), "L": (24, 1024, 16), "B": (12, 768, 12), "S": (12, 384, 6)}


def create_fit(name: str, device="cuda", **kwargs) -> FiT:
    """A FiT by registry name, e.g. ``create_fit("FiT-XL/2", dtype=torch.bfloat16)``,
    built on the card unless ``device`` names another (``"cpu"``, ``"meta"``)."""
    size, patch = name.removeprefix("FiT-").split("/")
    depth, hidden, heads = _SIZES[size]
    return FiT(
        depth=depth, hidden_size=hidden, num_heads=heads, patch_size=int(patch),
        device=resolve_device(device), **kwargs,
    )


FiT_models = {
    f"FiT-{size}/{patch}": (lambda name: lambda **kw: create_fit(name, **kw))(f"FiT-{size}/{patch}")
    for size in _SIZES
    for patch in (2, 4, 8)
}
