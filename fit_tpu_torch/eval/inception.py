"""InceptionV3 to pool3, the feature network of FID, sFID, IS and
Precision/Recall, as a PyTorch module.

Counterpart of ``fit_tpu/eval/inception.py``, in NCHW (PyTorch's layout)
and fp32 on the card: TF32 stays off inside the network whatever the
process's flags say, so the features are those of a float32 network.

* Each ``BasicConv2d`` (convolution, inference BatchNorm, relu) is one
  biased ``F.conv2d`` with the BatchNorm folded into its weight and bias at
  conversion (``convert_torch_inception``), then a relu.
* It loads torchvision ``inception_v3`` state dicts and pytorch-fid's
  ``pt_inception-2015-12-05`` (the same module names). ``variant="fid"``
  is pytorch-fid's ``FIDInception`` pooling (``count_include_pad=False``
  average pools in the A, C and E1 blocks, a max pool in E2), comparable
  with published FIDs; ``"torchvision"`` is the stock pooling.
* The input is (N, 3, H, W) in [0, 1], resized to 299 x 299 bilinearly with
  antialiasing when it shrinks (``fit_tpu``'s ``jax.image.resize``, not
  pytorch-fid's plain bilinear resize) and mapped to [-1, 1].
* ``spatial`` is the ADM evaluator's sFID embedding: Mixed_6d's branch1x1
  relu, its first 7 channels, flattened in (H, W, C) order to 2023 values.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fit_tpu_torch.utils.device import resolve_device

__all__ = [
    "InceptionV3",
    "convert_torch_inception",
    "load_torch_inception",
    "pool3_features",
    "pool3_and_spatial_features",
    "inception_logits",
    "make_feature_extractor",
    "make_logits_extractor",
    "make_suite_extractor",
]

_EPS = 1e-3  # torchvision BasicConv2d BatchNorm eps
_SIDE = 299
_VARIANTS = ("fid", "torchvision")
_NO_FC = ("params carry no fc head (checkpoint converted without fc weights) — Inception Score needs the "
          "classifier layer")


@contextlib.contextmanager
def _full_fp32():
    """cuDNN convolutions and matmuls in full fp32 (TF32 off) inside the block."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _conv(cin: int, cout: int, kernel, stride: int = 1, padding=0) -> nn.Conv2d:
    """A BasicConv2d with its BatchNorm folded in: a biased convolution."""
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=True)


def _cr(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return F.relu(conv(x))


def _avg_pool(x: torch.Tensor, count_include_pad: bool = True) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=count_include_pad)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int) -> None:
        super().__init__()
        self.branch1x1 = _conv(cin, 64, 1)
        self.branch5x5_1 = _conv(cin, 48, 1)
        self.branch5x5_2 = _conv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = _conv(cin, 64, 1)
        self.branch3x3dbl_2 = _conv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = _conv(96, 96, 3, padding=1)
        self.branch_pool = _conv(cin, pool_features, 1)

    def forward(self, x: torch.Tensor, fid: bool) -> torch.Tensor:
        b1 = _cr(self.branch1x1, x)
        b5 = _cr(self.branch5x5_2, _cr(self.branch5x5_1, x))
        b3 = _cr(self.branch3x3dbl_3, _cr(self.branch3x3dbl_2, _cr(self.branch3x3dbl_1, x)))
        bp = _cr(self.branch_pool, _avg_pool(x, count_include_pad=not fid))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int) -> None:
        super().__init__()
        self.branch3x3 = _conv(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = _conv(cin, 64, 1)
        self.branch3x3dbl_2 = _conv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = _conv(96, 96, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = _cr(self.branch3x3, x)
        bd = _cr(self.branch3x3dbl_3, _cr(self.branch3x3dbl_2, _cr(self.branch3x3dbl_1, x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int) -> None:
        super().__init__()
        self.branch1x1 = _conv(cin, 192, 1)
        self.branch7x7_1 = _conv(cin, c7, 1)
        self.branch7x7_2 = _conv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = _conv(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = _conv(cin, c7, 1)
        self.branch7x7dbl_2 = _conv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = _conv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = _conv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = _conv(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = _conv(cin, 192, 1)

    def forward(self, x: torch.Tensor, fid: bool, b1: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``b1``: this block's branch1x1 output when the caller has it (the sFID tap)."""
        b1 = _cr(self.branch1x1, x) if b1 is None else b1
        b7 = _cr(self.branch7x7_3, _cr(self.branch7x7_2, _cr(self.branch7x7_1, x)))
        bd = _cr(self.branch7x7dbl_1, x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = _cr(conv, bd)
        bp = _cr(self.branch_pool, _avg_pool(x, count_include_pad=not fid))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int) -> None:
        super().__init__()
        self.branch3x3_1 = _conv(cin, 192, 1)
        self.branch3x3_2 = _conv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = _conv(cin, 192, 1)
        self.branch7x7x3_2 = _conv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = _conv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = _conv(192, 192, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = _cr(self.branch3x3_2, _cr(self.branch3x3_1, x))
        b7 = _cr(self.branch7x7x3_1, x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = _cr(conv, b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int) -> None:
        super().__init__()
        self.branch1x1 = _conv(cin, 320, 1)
        self.branch3x3_1 = _conv(cin, 384, 1)
        self.branch3x3_2a = _conv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = _conv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = _conv(cin, 448, 1)
        self.branch3x3dbl_2 = _conv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = _conv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = _conv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = _conv(cin, 192, 1)

    def forward(self, x: torch.Tensor, pool: str) -> torch.Tensor:
        """``pool``: "avg" (torchvision), "avg_nopad" (pytorch-fid's E_1) or
        "max" (pytorch-fid's E_2)."""
        b1 = _cr(self.branch1x1, x)
        b3 = _cr(self.branch3x3_1, x)
        b3 = torch.cat([_cr(self.branch3x3_2a, b3), _cr(self.branch3x3_2b, b3)], 1)
        bd = _cr(self.branch3x3dbl_2, _cr(self.branch3x3dbl_1, x))
        bd = torch.cat([_cr(self.branch3x3dbl_3a, bd), _cr(self.branch3x3dbl_3b, bd)], 1)
        if pool == "max":
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        else:
            bp = _avg_pool(x, count_include_pad=pool == "avg")
        bp = _cr(self.branch_pool, bp)
        return torch.cat([b1, b3, bd, bp], 1)


class InceptionV3(nn.Module):
    """The network to pool3 (2048), with the ``fc`` classifier when
    ``num_classes`` is given (1000 for torchvision, 1008 for pytorch-fid).
    Every convolution carries its folded BatchNorm as its bias."""

    def __init__(self, num_classes: Optional[int] = None) -> None:
        super().__init__()
        self.Conv2d_1a_3x3 = _conv(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = _conv(32, 32, 3)
        self.Conv2d_2b_3x3 = _conv(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = _conv(64, 80, 1)
        self.Conv2d_4a_3x3 = _conv(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = nn.Linear(2048, num_classes) if num_classes else None

    def forward(
        self, images: torch.Tensor, variant: str = "fid", spatial: bool = False
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(N, 3, H, W) in [0, 1] -> (pool3 (N, 2048), spatial (N, 2023) or None)."""
        if variant not in _VARIANTS:
            raise ValueError(f"unknown variant {variant!r}: use 'fid' or 'torchvision'")
        fid = variant == "fid"
        with _full_fp32():
            x = images.to(self.Conv2d_1a_3x3.weight.device, torch.float32)
            if tuple(x.shape[2:]) != (_SIDE, _SIDE):
                x = F.interpolate(x, size=(_SIDE, _SIDE), mode="bilinear", align_corners=False, antialias=True)
            x = 2.0 * x - 1.0
            x = _cr(self.Conv2d_1a_3x3, x)
            x = _cr(self.Conv2d_2a_3x3, x)
            x = _cr(self.Conv2d_2b_3x3, x)
            x = F.max_pool2d(x, 3, stride=2)
            x = _cr(self.Conv2d_3b_1x1, x)
            x = _cr(self.Conv2d_4a_3x3, x)
            x = F.max_pool2d(x, 3, stride=2)
            for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d):
                x = block(x, fid)
            x = self.Mixed_6a(x)
            x = self.Mixed_6b(x, fid)
            x = self.Mixed_6c(x, fid)
            sp = b1 = None
            if spatial:
                b1 = _cr(self.Mixed_6d.branch1x1, x)
                sp = b1[:, :7].permute(0, 2, 3, 1).reshape(b1.shape[0], -1)
            x = self.Mixed_6d(x, fid, b1=b1)
            x = self.Mixed_6e(x, fid)
            x = self.Mixed_7a(x)
            x = self.Mixed_7b(x, "avg_nopad" if fid else "avg")
            x = self.Mixed_7c(x, "max" if fid else "avg")
            return x.mean(dim=(2, 3)), sp

    def logits(self, pool3: torch.Tensor) -> torch.Tensor:
        if self.fc is None:
            raise ValueError(_NO_FC)
        with _full_fp32():
            return self.fc(pool3)


def _images(model: InceptionV3, images) -> torch.Tensor:
    return torch.as_tensor(images, dtype=torch.float32, device=model.Conv2d_1a_3x3.weight.device)


def pool3_features(model: InceptionV3, images, variant: str = "fid") -> torch.Tensor:
    """(N, 3, H, W) images in **[0, 1]** (a tensor or an array) -> (N, 2048)
    pool3 features, on the model's device."""
    with torch.inference_mode():
        return model(_images(model, images), variant)[0]


def pool3_and_spatial_features(model: InceptionV3, images, variant: str = "fid") -> Tuple[torch.Tensor, torch.Tensor]:
    """One trunk pass -> (pool3 (N, 2048), spatial (N, 2023)): the
    features of FID and of sFID (Nash et al. 2021), the same Frechet
    distance over the 17 x 17 mid-network embedding."""
    with torch.inference_mode():
        return model(_images(model, images), variant, spatial=True)


def inception_logits(model: InceptionV3, images, variant: str = "fid") -> torch.Tensor:
    """(N, 3, H, W) images in [0, 1] -> (N, num_classes) logits of the
    ``fc`` head; raises if the checkpoint had none."""
    if model.fc is None:
        raise ValueError(_NO_FC)
    with torch.inference_mode():
        return model.logits(model(_images(model, images), variant)[0])


def _on(model: InceptionV3, device) -> InceptionV3:
    """``model`` on ``device`` (the card unless named): itself if it is
    there, else a copy moved there, so the caller's module stays put."""
    dev = resolve_device(device)
    at = model.Conv2d_1a_3x3.weight.device
    if at.type == dev.type and (dev.index is None or dev.index == at.index):
        return model
    return copy.deepcopy(model).to(dev)


def make_feature_extractor(model: InceptionV3, variant: str = "fid", device="cuda"):
    """Numpy in, numpy out pool3 extractor (``fid_score``'s ``extractor``),
    running on ``device``."""
    model = _on(model, device)

    def extract(batch: np.ndarray) -> np.ndarray:
        return pool3_features(model, batch, variant).cpu().numpy()

    return extract


def make_logits_extractor(model: InceptionV3, variant: str = "fid", device="cuda"):
    """Numpy in, numpy out class probabilities (softmaxed logits), for
    ``inception_score``."""
    if model.fc is None:
        raise ValueError(_NO_FC)
    model = _on(model, device)

    def extract(batch: np.ndarray) -> np.ndarray:
        return torch.softmax(inception_logits(model, batch, variant), dim=-1).cpu().numpy()

    return extract


def make_suite_extractor(
    model: InceptionV3, variant: str = "fid", spatial: bool = False, probs: bool = False, device="cuda"
):
    """Numpy in, dict out: every requested embedding from ONE trunk pass,
    always ``pool3`` (FID, Precision/Recall), with ``spatial`` (sFID) and
    ``probs`` (Inception Score) when asked, on ``device``."""
    if probs and model.fc is None:
        raise ValueError(_NO_FC)
    model = _on(model, device)

    def extract(batch: np.ndarray) -> Dict[str, np.ndarray]:
        with torch.inference_mode():
            pool3, sp = model(_images(model, batch), variant, spatial=spatial)
            out = {"pool3": pool3}
            if spatial:
                out["spatial"] = sp
            if probs:
                out["probs"] = torch.softmax(model.logits(pool3), dim=-1)
        return {k: v.cpu().numpy() for k, v in out.items()}

    return extract


def _fold(sd: Dict, prefix: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """A torch BasicConv2d's convolution and inference BatchNorm -> one
    convolution's (weight, bias)."""

    def get(key):
        return torch.as_tensor(np.asarray(sd[f"{prefix}.{key}"], np.float32))

    scale = get("bn.weight") / torch.sqrt(get("bn.running_var") + _EPS)
    return get("conv.weight") * scale[:, None, None, None], get("bn.bias") - get("bn.running_mean") * scale


def convert_torch_inception(sd: Dict) -> InceptionV3:
    """A torchvision or pytorch-fid InceptionV3 state dict (tensors or
    arrays) -> an fp32 :class:`InceptionV3` on the CPU, with the ``fc``
    head when the state dict has one. AuxLogits are dropped: no metric
    uses them."""
    sd = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v for k, v in sd.items()}
    num_classes = int(np.shape(sd["fc.weight"])[0]) if "fc.weight" in sd else None
    with torch.device("meta"):
        model = InceptionV3(num_classes)
    state = {}
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Conv2d):
            state[f"{name}.weight"], state[f"{name}.bias"] = _fold(sd, name)
    if num_classes:
        state["fc.weight"] = torch.as_tensor(np.asarray(sd["fc.weight"], np.float32))
        state["fc.bias"] = torch.as_tensor(np.asarray(sd["fc.bias"], np.float32))
    model.load_state_dict(state, assign=True)
    return model.eval()


def load_torch_inception(path: str) -> InceptionV3:
    """Load a torch .pth/.pt InceptionV3 checkpoint and convert it (CPU)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return convert_torch_inception(sd)
