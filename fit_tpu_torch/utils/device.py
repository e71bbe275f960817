"""The device an entry point runs on.

Every entry point of the port (``create_fit``, ``FiTSampler``,
``SamplingServer``, ``Trainer``) runs on the card unless its caller asks for
another device: without a CUDA card and without ``device="cpu"`` it raises,
so a run never lands on the CPU unannounced.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device`` ("cuda" when None); raises if it is a
    CUDA device and there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fit_tpu_torch runs on a CUDA card and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
