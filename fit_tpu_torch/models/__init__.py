"""The FiT and DiT denoisers, their layers and the flax weight converter.

``fit_tpu.models`` also exports ``MoeSwiGLU`` (a top-1 Switch FFN), which
the port has not ported; its mixture of experts is DiT-MoE's
``SparseMoeBlock``. ``Flux`` is FLUX.1's two-stream rectified-flow
transformer and ``WanModel`` Wan2.1's text-to-video one, neither of which
``fit_tpu`` has.
"""

from fit_tpu_torch._exports import lazy_exports

__all__, __getattr__, __dir__ = lazy_exports(
    __name__,
    {
        ".convert": (
            "convert_torch_fit_state_dict",
            "load_torch_fit_checkpoint",
        ),
        ".dit": (
            "DiT",
            "DiT_models",
            "DiT_MoE_models",
            "create_dit",
        ),
        ".moe": ("SparseMoeBlock",),
        ".flux": (
            "DoubleStreamBlock",
            "Flux",
            "LastLayer",
            "MLPEmbedder",
            "SingleStreamBlock",
            "create_flux",
        ),
        ".wan": (
            "WanAttentionBlock",
            "WanModel",
            "create_wan",
        ),
        ".fit": (
            "FiT",
            "FiT_models",
            "create_fit",
        ),
        ".layers": (
            "FinalLayer",
            "FiTBlock",
            "GeluMlp",
            "LabelEmbedder",
            "SelfAttention",
            "SwiGLU",
            "TimestepEmbedder",
            "apply_rope",
            "layer_norm_fp32",
            "modulate",
        ),
    },
)
