"""Device choice, configuration, checkpoints and metrics logging."""

from fit_tpu_torch._exports import lazy_exports

__all__, __getattr__, __dir__ = lazy_exports(
    __name__,
    {
        ".checkpoint": (
            "CheckpointManager",
        ),
        ".config": (
            "PreprocessConfig",
            "SampleConfig",
            "TrainConfig",
        ),
        ".logging": (
            "MetricLogger",
        ),
    },
)
