"""Hand-written Hopper kernels, each beside its plain PyTorch version."""

import collections

from fit_tpu_torch._exports import lazy_exports

__all__, __getattr__, __dir__ = lazy_exports(__name__, {".attention": ("mask_to_lengths", "masked_attention")})
__all__ += ["LAUNCHES", "launch_counts"]

# Kernel launches by kernel name, since each module's last reset_launches();
# the wrappers add to it, and each module's ``launches`` attributes read it.
KERNELS = ("rope_attention_fwd", "rope_attention_bwd", "rope_flash_attention", "masked_attention", "adaln_quant",
           "silu_mul_quant", "adaln_modulate", "swiglu_glue")
LAUNCHES = collections.Counter()


def launch_counts() -> dict:
    """Every kernel wrapper's launch count since its module's last reset,
    by kernel name."""
    return {k: LAUNCHES[k] for k in KERNELS}
