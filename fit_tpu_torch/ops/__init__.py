"""Hand-written Hopper kernels, each beside its plain PyTorch version."""

from fit_tpu_torch._exports import lazy_exports

__all__, __getattr__, __dir__ = lazy_exports(__name__, {".attention": ("mask_to_lengths", "masked_attention")})
__all__ += ["launch_counts"]


def launch_counts() -> dict:
    """Every kernel wrapper's launch count since its module's last reset,
    by kernel name."""
    from fit_tpu_torch.ops import attention, fused_adaln, quant, rope_attention

    return {"rope_attention_fwd": rope_attention.launches, "rope_attention_bwd": rope_attention.bwd_launches,
            "rope_flash_attention": rope_attention.flash_launches, "masked_attention": attention.launches,
            **quant.launches, **fused_adaln.launches}
