"""Sample-quality evaluation: InceptionV3 features on the card, FID, sFID,
Inception Score and Precision/Recall on the host."""

from fit_tpu_torch._exports import lazy_exports

__all__, __getattr__, __dir__ = lazy_exports(
    __name__,
    {
        ".fid": (
            "feature_statistics",
            "fid_from_features",
            "fid_score",
            "frechet_distance",
        ),
        ".inception": (
            "convert_torch_inception",
            "load_torch_inception",
            "make_feature_extractor",
            "make_suite_extractor",
            "pool3_and_spatial_features",
            "pool3_features",
        ),
    },
)
