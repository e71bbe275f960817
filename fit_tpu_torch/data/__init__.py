"""Host-side latent dataset and batch loader (the native C++ packer, or numpy)."""

from fit_tpu_torch._exports import lazy_exports

__all__, __getattr__, __dir__ = lazy_exports(
    __name__,
    {
        ".dataset": (
            "TOKEN_BUCKETS",
            "LatentExample",
            "LatentFolderDataset",
            "LatentLoader",
            "bucket_batch",
            "pad_batch",
        ),
    },
)
