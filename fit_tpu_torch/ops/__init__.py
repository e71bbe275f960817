"""Hand-written Hopper kernels, each beside its plain PyTorch version."""

import collections

from fit_tpu_torch._exports import lazy_exports

__all__, __getattr__, __dir__ = lazy_exports(__name__, {".attention": ("mask_to_lengths", "masked_attention")})
__all__ += ["LAUNCHES", "launch_counts", "reset_launches"]

# Kernel launches by kernel name since the last reset_launches(); the
# wrappers add to it.
KERNELS = ("rope_attention_fwd", "rope_attention_bwd", "rope_flash_attention", "masked_attention", "adaln_quant",
           "silu_mul_quant", "adaln_modulate", "adaln_residual", "swiglu_glue", "moe_grouped_mm",
           "moe_combine", "qk_norm", "gelu_glue", "rope_attention_rotate_k", "cross_attention",
           "qk_norm_wide")
LAUNCHES = collections.Counter()


def launch_counts() -> dict:
    """Every kernel wrapper's launch count since the last
    :func:`reset_launches`, by kernel name."""
    return {k: LAUNCHES[k] for k in KERNELS}


def reset_launches() -> None:
    """Sets every launch count to 0."""
    LAUNCHES.clear()
